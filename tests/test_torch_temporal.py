"""The port's temporal smoother (``video/temporal.py``) and the runner's
``temporal_smooth`` / ``fetch_pack`` options against the JAX package.

The same numpy depth maps go through the port's device update (torch on the
CPU), its host twin and the JAX package's jitted update, within rtol 1e-5 /
atol 1e-6. The runner streams base frames plus integer noise in [-3, 3] (so
that most pixels are static and the smoother blends), with the params of one
npz shared by both packages, fp32, and matches the JAX runner within rtol
1e-3 / atol 1e-4 (plus ``max_rel_error`` when packed). The retry tests are
ports of ``tests/test_temporal.py``'s: the EMA advances once per frame, and a
poisoned computation is re-smoothed from the last collected state.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.video import temporal as jtemporal
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.video import runner as runner_mod
from ml_depth_pro_video_tpu_torch.video import temporal
from ml_depth_pro_video_tpu_torch.video.pack import max_rel_error
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint

RTOL, ATOL = 1e-5, 1e-6              # the update, fp32 against fp32
RUN_RTOL, RUN_ATOL = 1e-3, 1e-4      # the runner streams: the JAX parity bar
CUDA_FAULT = "CUDA error: an illegal memory access was encountered (injected)"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


def _scene(h=32, w=40, seed=0) -> np.ndarray:
    return (2.0 + np.random.default_rng(seed).random((h, w))).astype(np.float32)


def _sequence(kind: str, n: int = 6, seed: int = 1) -> list:
    """Depth maps in playback order: noise on a static scene, a global scale
    flicker, an object that jumps closer, or a scene cut."""
    base = _scene()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = base * (1.0 + 0.01 * rng.standard_normal(base.shape)).astype(np.float32)
        if kind == "flicker":
            d = d * (1.0 + 0.1 * (-1) ** i)
        elif kind == "motion" and i >= n // 2:
            d[10:20, 10:20] = 0.8
        elif kind == "cut" and i >= n // 2:
            d = d[::-1, ::-1] * 5.0
        out.append(d.astype(np.float32))
    return out


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("kind", ["noise", "flicker", "motion", "cut"])
def test_update_matches_jax_and_host_twin(kind, align):
    frames = _sequence(kind)
    state_t = torch.from_numpy(frames[0])
    state_j = state_n = frames[0]
    for d in frames[1:]:
        state_t, out_t = temporal._update_core(state_t, torch.from_numpy(d), alpha=0.8, tau=0.05,
                                               align=align)
        state_j, out_j = jtemporal._update(state_j, d, alpha=0.8, tau=0.05, align=align)
        state_n, out_n = temporal._update_core_np(state_n, d, alpha=0.8, tau=0.05, align=align)
        assert out_t.dtype == torch.float32 and out_t.shape == d.shape
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out_t.numpy(), out_n, rtol=RTOL, atol=ATOL)
    if kind == "noise":  # the smoother did blend: the output is not the last frame
        assert np.abs(out_t.numpy() - frames[-1]).max() > 1e-3


def test_host_twin_is_copied_unchanged():
    frames = _sequence("flicker")
    for d in frames[1:]:
        got = temporal._update_core_np(frames[0], d, alpha=0.7, tau=0.05, align=True)
        want = jtemporal._update_core_np(frames[0], d, alpha=0.7, tau=0.05, align=True)
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("n", [None, 3])
def test_smooth_batch_equals_sequential_smoother(n):
    """Rows from ``n`` on pass through unsmoothed and leave the state alone;
    the seed row passes through; a second batch continues the state."""
    frames = np.stack(_sequence("noise", n=8))
    seq = temporal.TemporalSmoother(alpha=0.8, device="cpu")
    host = temporal.TemporalSmoother(alpha=0.8, host=True)
    b1, b2 = torch.from_numpy(frames[:4]), torch.from_numpy(frames[4:])
    state, out1 = temporal.smooth_batch(None, b1, n, alpha=0.8)
    state, out2 = temporal.smooth_batch(state, b2, n, alpha=0.8)
    j_state, j_out1 = jtemporal.smooth_batch(None, frames[:4], n, alpha=0.8)
    _, j_out2 = jtemporal.smooth_batch(j_state, frames[4:], n, alpha=0.8)
    k = 4 if n is None else n
    want = [seq.update(f) for f in list(frames[:k]) + list(frames[4:4 + k])]
    want_host = [host.update(f) for f in list(frames[:k]) + list(frames[4:4 + k])]
    got = list(out1[:k].numpy()) + list(out2[:k].numpy())
    np.testing.assert_array_equal(out1[0].numpy(), frames[0])
    for g, w, h in zip(got, want, want_host):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, h, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out1[k:].numpy(), frames[k:4])  # padding passes through
    np.testing.assert_allclose(torch.cat([out1, out2]).numpy(),
                               np.concatenate([np.asarray(j_out1), np.asarray(j_out2)]),
                               rtol=RTOL, atol=ATOL)


def test_resolution_change_reseeds():
    a, b = _sequence("noise", n=3), [f[:16, :24].copy() for f in _sequence("noise", n=3, seed=4)]
    sm = temporal.TemporalSmoother(alpha=0.8, device="cpu")
    outs = [sm.update(f) for f in a + b]
    np.testing.assert_array_equal(outs[3], b[0])  # the first frame at the new size passes
    state, _ = temporal.smooth_batch(None, torch.from_numpy(np.stack(a)), alpha=0.8)
    _, out = temporal.smooth_batch(state, torch.from_numpy(np.stack(b)), alpha=0.8)
    np.testing.assert_array_equal(out[0].numpy(), b[0])
    sm.reset()
    np.testing.assert_array_equal(sm.update(a[1]), a[1])


@pytest.mark.parametrize("alpha", [1.0, -0.1, 1.5])
def test_invalid_alpha_raises(alpha, tmp_path):
    with pytest.raises(ValueError):
        temporal.TemporalSmoother(alpha=alpha, device="cpu")
    with pytest.raises(ValueError):
        temporal.smooth_batch(None, torch.ones(2, 4, 4), alpha=alpha)
    path = tmp_path / "f_000001.npy"
    np.save(path, _scene())
    before = path.read_bytes()
    with pytest.raises(ValueError):
        temporal.smooth_depth_files([str(path)], alpha=alpha, device="cpu")
    assert path.read_bytes() == before and sorted(os.listdir(tmp_path)) == [path.name]


def _write_maps(folder, frames, fmt):
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, d in enumerate(frames):
        path = folder / f"frame_{i:03d}_depth.{fmt}"
        if fmt == "npy":
            np.save(path, d)
        else:
            np.savez_compressed(path, depth=d, focallength_px=np.float32(100.0 + i))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("fmt", ["npz", "npy"])
@pytest.mark.parametrize("in_place", [True, False])
def test_smooth_depth_files_writes_what_jax_writes(tmp_path, fmt, in_place):
    """Both packages over copies of the same files, chunk 3 with a resolution
    change mid-sequence: same names, same other arrays, depth within tolerance,
    and no temp file left."""
    frames = _sequence("flicker", n=5) + [f[:20, :30].copy() for f in _sequence("noise", n=3)]
    ours = _write_maps(tmp_path / "port", frames, fmt)
    theirs = _write_maps(tmp_path / "jax", frames, fmt)
    out_t = None if in_place else str(tmp_path / "port_out")
    out_j = None if in_place else str(tmp_path / "jax_out")
    assert temporal.smooth_depth_files(ours, out_t, chunk=3, device="cpu") == len(frames)
    assert jtemporal.smooth_depth_files(theirs, out_j, chunk=3) == len(frames)
    dir_t = tmp_path / ("port" if in_place else "port_out")
    dir_j = tmp_path / ("jax" if in_place else "jax_out")
    assert sorted(os.listdir(dir_t)) == sorted(os.listdir(dir_j))
    assert not any(name.endswith(".tmp") for name in os.listdir(dir_t))
    for name in sorted(os.listdir(dir_t)):
        if fmt == "npy":
            got, want = np.load(dir_t / name), np.load(dir_j / name)
        else:
            with np.load(dir_t / name) as zt, np.load(dir_j / name) as zj:
                assert zt.files == zj.files
                assert zt["focallength_px"] == zj["focallength_px"]
                got, want = zt["depth"], zj["depth"]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_smooth_depth_files_refuses_a_missing_key(tmp_path):
    path = tmp_path / "a.npz"
    np.savez(path, other=_scene())
    with pytest.raises(KeyError, match="depth"):
        temporal.smooth_depth_files([str(path)], device="cpu")


def _noisy_frames(n, seed, h=64, w=64):
    """One base frame plus integer noise in [-3, 3] per frame: most pixels are
    static, so the smoother blends them."""
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    return [np.clip(base.astype(np.int16) + rng.integers(-3, 4, base.shape), 0, 255)
            .astype(np.uint8) for _ in range(n)]


def _runner(checkpoint, **kwargs):
    cfg = dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint)
    return DepthVideoRunner(cfg=cfg, precision="fp32", batch_size=2, decode_workers=1,
                            device="cpu", **kwargs)


@pytest.mark.parametrize("smooth,fetch_pack", [(0.8, "none"), (0.0, "u16"), (0.8, "u16")])
def test_runner_options_match_jax_runner(checkpoint, smooth, fetch_pack):
    frames = _noisy_frames(5, seed=3)
    items = frames[:3] + [(frames[3], 60.0), frames[4]]  # a tail batch, a mixed-EXIF batch
    jcfg = dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint)
    jaxr = JaxRunner(cfg=jcfg, precision="fp32", batch_size=2, decode_workers=1,
                     temporal_smooth=smooth, fetch_pack=fetch_pack)
    got = list(_runner(checkpoint, temporal_smooth=smooth, fetch_pack=fetch_pack)
               .depth_stream(items))
    ref = list(jaxr.depth_stream(items))
    plain = list(_runner(checkpoint).depth_stream(items))
    rtol = RUN_RTOL + (max_rel_error() if fetch_pack == "u16" else 0.0)
    assert len(got) == len(ref) == 5
    for g, r, p in zip(got, ref, plain):
        assert g["depth"].dtype == np.float32 and g["depth"].shape == (64, 64)
        np.testing.assert_allclose(g["depth"], r["depth"], rtol=rtol, atol=RUN_ATOL)
        np.testing.assert_allclose(g["focallength_px"], r["focallength_px"], rtol=RUN_RTOL,
                                   atol=RUN_ATOL)
        if fetch_pack == "u16" and not smooth:
            np.testing.assert_allclose(g["depth"], p["depth"], rtol=max_rel_error() + 1e-5)
    if smooth:  # frame 0 seeds the state and passes through; later frames are blended
        np.testing.assert_allclose(got[0]["depth"], plain[0]["depth"],
                                   rtol=max_rel_error() + 1e-5)
        assert max(np.abs(g["depth"] - p["depth"]).max() for g, p in zip(got[1:], plain[1:])) \
            > 1e-4


class _FlakyFetch:
    """Stands in for a fetched tensor; its host read raises a CUDA runtime error."""

    def numpy(self):
        raise RuntimeError(CUDA_FAULT)


def test_runner_smoothing_retry_does_not_double_advance(checkpoint, monkeypatch):
    """A fetch failure after the smoothed depth was computed (here the focal
    length's read) re-dispatches the batch and re-smooths it; the EMA must
    advance once per frame, so the stream equals one without the failure."""
    frames = _noisy_frames(4, seed=6)
    expected = [r["depth"] for r in _runner(checkpoint, temporal_smooth=0.8)
                .depth_stream(frames)]
    runner = _runner(checkpoint, temporal_smooth=0.8, max_retries=2)
    real_infer, calls = runner._infer, {"n": 0}

    def flaky_infer(*args):
        out = dict(real_infer(*args))
        calls["n"] += 1
        if calls["n"] == 1:  # first batch, first attempt only
            out["focallength_px"] = _FlakyFetch()
        return out

    monkeypatch.setattr(runner, "_infer", flaky_infer)
    monkeypatch.setattr(runner_mod.time, "sleep", lambda s: None)
    assert runner_mod._is_device_error(RuntimeError(CUDA_FAULT))
    got = [r["depth"] for r in runner.depth_stream(frames)]
    assert calls["n"] == 3  # 2 batches + 1 re-dispatch
    assert len(got) == 4
    for w, g in zip(expected, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


class _Poisoned:
    """A tensor whose computation failed: what is computed from it is
    poisoned too, and any host read raises."""

    def __init__(self, t):
        self.t = t

    @property
    def shape(self):
        return self.t.shape

    def numpy(self):
        raise RuntimeError(CUDA_FAULT)


def test_runner_smoothing_survives_poisoned_state_chain(checkpoint, monkeypatch):
    """A failed computation in batch 2 poisons its smoothed depth and the EMA
    state that batches 3 and 4 were smoothed from at dispatch. The retry must
    re-smooth batch 2 from the last collected state and re-chain the later
    flights (and the state of the next dispatch), or every later batch fails
    at its collect."""
    frames = _noisy_frames(8, seed=7)
    expected = [r["depth"] for r in _runner(checkpoint, temporal_smooth=0.8)
                .depth_stream(frames)]
    real_smooth = temporal.smooth_batch

    def chaining_smooth(state, depths, n=None, **kw):
        tainted = isinstance(state, _Poisoned) or isinstance(depths, _Poisoned)
        st = state.t if isinstance(state, _Poisoned) else state
        d = depths.t if isinstance(depths, _Poisoned) else depths
        new_state, out = real_smooth(st, d, n, **kw)
        return (_Poisoned(new_state), _Poisoned(out)) if tainted else (new_state, out)

    runner = _runner(checkpoint, temporal_smooth=0.8, max_retries=2)
    real_infer, calls = runner._infer, {"n": 0}

    def flaky_infer(*args):
        out = dict(real_infer(*args))
        calls["n"] += 1
        if calls["n"] == 2:  # the second batch's computation fails
            out["depth"] = _Poisoned(out["depth"])
        return out

    monkeypatch.setattr(temporal, "smooth_batch", chaining_smooth)
    monkeypatch.setattr(runner, "_infer", flaky_infer)
    monkeypatch.setattr(runner_mod.time, "sleep", lambda s: None)
    got = [r["depth"] for r in runner.depth_stream(frames)]
    assert len(got) == 8
    # batch 2's collect retried once; batches 3 and 4 needed no retry of their own
    assert calls["n"] == 5, calls["n"]
    for w, g in zip(expected, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
