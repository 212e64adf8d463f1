"""The PyTorch port's streaming runner and CLI, on the CPU.

The port's ``DepthVideoRunner(device="cpu")`` and the JAX package's
``DepthVideoRunner`` load the SAME params (a flat npz written by the JAX
package's ``save_params``, every leaf randomized from a numpy seed) and
stream the same uint8 frames: a tail batch, a mixed-EXIF batch and a batch
where every frame carries a focal length. Both run fp32; the bar is the
JAX package's parity bar, rtol 1e-3 / atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.ckpt.export import export_infer
from ml_depth_pro_video_tpu_torch.ckpt.export import main as export_main
from ml_depth_pro_video_tpu_torch.cli import run as cli_run
from ml_depth_pro_video_tpu_torch.video import runner as runner_module
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Random tiny params as the JAX converter writes them; every leaf
    redrawn from numpy (biases and LayerScale included)."""
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


def _frames(n, h=60, w=84, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_port_image_io_matches_jax(tmp_path):
    """The port's own io.image against the JAX package's: EXIF rotation and
    focal length, a grayscale PNG, stream items with a given f_px, float
    arrays and a downscale."""
    from ml_depth_pro_video_tpu.io import image as j_image
    from ml_depth_pro_video_tpu_torch.io import image as t_image

    rgb = _frames(1, 30, 40, seed=3)[0]
    exif = Image.Exif()
    exif[0x0112] = 6                  # orientation: rotate
    exif[0x8769] = {0xA405: 35}       # FocalLengthIn35mmFilm
    jpg, png = tmp_path / "r.jpg", tmp_path / "g.png"
    Image.fromarray(rgb).save(jpg, exif=exif)
    Image.fromarray(rgb[..., 0]).save(png)
    for path in (jpg, png):
        t_img, _, t_f = t_image.load_rgb(path)
        j_img, _, j_f = j_image.load_rgb(path)
        np.testing.assert_array_equal(t_img, j_img)
        assert t_f == j_f
    assert t_image.load_rgb(jpg)[0].shape == (40, 30, 3) and t_image.load_rgb(jpg)[2] > 0
    floats = rgb.astype(np.float32) / 255.0
    for item, scale in [(str(jpg), 1.0), ((str(jpg), 500.0), 0.5), (floats, 1.0),
                        ((floats, 80.0), 0.5)]:
        t_key, t_img, t_f = t_image.load_stream_item(item, scale)
        j_key, j_img, j_f = j_image.load_stream_item(item, scale)
        assert t_key == j_key and t_f == j_f
        np.testing.assert_array_equal(t_img, j_img)


def test_port_runner_matches_jax_runner(checkpoint):
    frames = _frames(5)
    # batch 1: mixed EXIF; batch 2: no focal lengths; batch 3: tail, all given
    items = [frames[0], (frames[1], 70.0), frames[2], frames[3], (frames[4], 55.0)]
    port = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                            precision="fp32", batch_size=2, decode_workers=1, device="cpu")
    jaxr = JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint),
                     precision="fp32", batch_size=2, decode_workers=1)
    got = list(port.depth_stream(items))
    ref = list(jaxr.depth_stream(items))
    assert len(got) == len(ref) == 5
    for g, r, img in zip(got, ref, frames):
        assert g["key"] is None and g["image"] is img
        assert g["depth"].shape == (60, 84) and g["depth"].dtype == np.float32
        np.testing.assert_allclose(g["depth"], r["depth"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["focallength_px"], r["focallength_px"], rtol=RTOL,
                                   atol=ATOL)
    assert got[1]["focallength_px"] == 70.0 and got[4]["focallength_px"] == 55.0


def test_port_runner_resolution_change_and_infer_one(checkpoint):
    runner = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                              precision="fp32", batch_size=3, decode_workers=2, device="cpu")
    items = _frames(2, 40, 50) + _frames(2, 30, 70, seed=1)
    out = list(runner.depth_stream(items))
    assert [o["depth"].shape for o in out] == [(40, 50)] * 2 + [(30, 70)] * 2
    one = runner.infer_one(items[0])
    np.testing.assert_allclose(one["depth"], out[0]["depth"], rtol=1e-6, atol=0)


def test_port_runner_reads_paths_in_a_process_pool(checkpoint, tmp_path):
    paths = []
    for i, img in enumerate(_frames(2, 32, 48)):
        paths.append(str(tmp_path / f"f{i}.png"))
        Image.fromarray(img).save(paths[-1])
    runner = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                              precision="fp32", batch_size=2, decode_workers=1,
                              decode_pool="process", device="cpu")
    out = list(runner.depth_stream(paths + [str(tmp_path / "missing.png")]))
    assert [o["key"] for o in out] == paths  # the unreadable frame is skipped
    assert all(np.isfinite(o["depth"]).all() for o in out)


def test_runner_retries_device_errors_only(checkpoint, monkeypatch):
    from ml_depth_pro_video_tpu_torch.video import runner as runner_mod

    runner = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                              precision="fp32", batch_size=2, decode_workers=1, max_retries=1,
                              device="cpu")
    monkeypatch.setattr(runner_mod.time, "sleep", lambda s: None)
    real_infer, calls = runner._infer, []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real_infer(*args)

    monkeypatch.setattr(runner, "_infer", flaky)
    assert len(list(runner.depth_stream(_frames(2)))) == 2 and len(calls) == 2

    def broken(*args):
        calls.append(1)
        raise ValueError("not a device error")

    monkeypatch.setattr(runner, "_infer", broken)
    calls.clear()
    with pytest.raises(ValueError):
        list(runner.depth_stream(_frames(2)))
    assert len(calls) == 1  # deterministic failures are not retried


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"parallel": "latency"}])
def test_unported_runner_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP A item 10 "):
        DepthVideoRunner(cfg=tiny_config(), device="cpu", **kwargs)


def test_runner_serves_exported_artifact(checkpoint, tmp_path, caplog):
    """Full batches at ``img_size`` go through the artifact and equal the
    eager runner's bit for bit; a batch at another size warns once and runs
    eagerly."""
    cfg = dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint)
    path = str(tmp_path / "tiny.pt2")
    export_infer(cfg, "fp32", batch_size=2, path=path, device="cpu")
    kw = dict(cfg=cfg, precision="fp32", batch_size=2, decode_workers=1, device="cpu")
    served, eager = DepthVideoRunner(exported_path=path, **kw), DepthVideoRunner(**kw)
    frames = _frames(3, cfg.img_size, cfg.img_size, seed=4)  # a full batch, then a padded one
    for got, want in zip(served.depth_stream(frames), eager.depth_stream(frames), strict=True):
        assert np.array_equal(got["depth"], want["depth"])
        assert got["focallength_px"] == want["focallength_px"]
    assert served.exported_calls == 2 and eager.exported_calls == 0
    small = _frames(2, seed=5)
    with caplog.at_level("WARNING"):
        got = [r["depth"] for r in served.depth_stream(small + small)]
    assert served.exported_calls == 2
    assert sum("does not serve this batch" in r.message for r in caplog.records) == 1
    for g, w in zip(got, [r["depth"] for r in eager.depth_stream(small + small)], strict=True):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="quantized"):
        DepthVideoRunner(exported_path=path, quantize=True, **kw)


@pytest.mark.parametrize("speed", ["balanced", "fast"])
def test_port_runner_speed_tier_matches_jax_runner(checkpoint, speed):
    """The runner applies the speed preset as the JAX runner does. The merge
    point is moved to after block 1 so that the 2-block tiny ViT merges."""
    from ml_depth_pro_video_tpu_torch.models import vit as TV

    merges = []
    real = TV.compute_token_merge

    def recording(tokens, ratio):
        merges.append(tokens.shape)
        return real(tokens, ratio)

    cfg = dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint, token_merge_block=1)
    jcfg = dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint, token_merge_block=1)
    port = DepthVideoRunner(cfg=cfg, precision="fp32", batch_size=2, decode_workers=1,
                            speed=speed, device="cpu")
    jaxr = JaxRunner(cfg=jcfg, precision="fp32", batch_size=2, decode_workers=1, speed=speed)
    assert port.cfg.token_merge_ratio == jaxr.cfg.token_merge_ratio > 0
    items = _frames(3, seed=2)
    TV.compute_token_merge = recording
    try:
        got = list(port.depth_stream(items))
    finally:
        TV.compute_token_merge = real
    ref = list(jaxr.depth_stream(items))
    assert merges == [(70, 65, 64)] * 2  # the patch ViT of each batch of 2 frames
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["depth"], r["depth"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["focallength_px"], r["focallength_px"], rtol=RTOL,
                                   atol=ATOL)


def test_unknown_speed_raises():
    with pytest.raises(ValueError, match="speed must be one of"):
        DepthVideoRunner(cfg=tiny_config(), device="cpu", speed="fastest")


def test_runner_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DepthVideoRunner(cfg=tiny_config())


def test_cli_writes_depth_for_one_png(tmp_path, capsys):
    img = tmp_path / "in" / "frame.png"
    img.parent.mkdir()
    Image.fromarray(_frames(1, 40, 56)[0]).save(img)
    out = tmp_path / "out"
    cli_run.main(["-i", str(img), "--model", "tiny", "--device", "cpu", "--skip-display",
                  "-o", str(out)])
    depth = np.load(out / "frame.npz")["depth"]
    assert depth.shape == (40, 56) and np.isfinite(depth).all() and (depth > 0).all()
    assert (out / "frame.jpg").exists()
    assert "wrote" in capsys.readouterr().out


def test_cli_serves_through_an_artifact(tmp_path, monkeypatch):
    """``depth-pro-run-torch --exported`` runs the forward through the artifact
    (an image at the tiny model's 512^2) and writes the eager run's depth."""
    img = tmp_path / "in" / "frame.png"
    img.parent.mkdir()
    Image.fromarray(_frames(1, 512, 512, seed=6)[0]).save(img)
    art = str(tmp_path / "tiny.pt2")
    export_main(["-o", art, "--tiny", "--device", "cpu", "--precision", "fp32"])
    runners = []

    class Recording(DepthVideoRunner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runners.append(self)

    monkeypatch.setattr(runner_module, "DepthVideoRunner", Recording)
    depths = []
    for extra in (["--exported", art], []):
        out = tmp_path / f"out{len(depths)}"
        cli_run.main(["-i", str(img), "--model", "tiny", "--device", "cpu", "--skip-display",
                      "--fp32", "-o", str(out), *extra])
        depths.append(np.load(out / "frame.npz")["depth"])
    assert [r.exported_calls for r in runners] == [1, 0]
    assert np.array_equal(*depths)


@pytest.mark.parametrize("speed", ["exact", "balanced", "fast"])
def test_cli_takes_every_speed(tmp_path, capsys, speed):
    img = tmp_path / "frame.png"
    Image.fromarray(_frames(1, 36, 44)[0]).save(img)
    cli_run.main(["-i", str(img), "--model", "tiny", "--device", "cpu", "--skip-display",
                  "--speed", speed])
    assert "frame.png: depth [" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_run.main(["-i", str(img), "--model", "tiny", "--device", "cpu", "--speed", "fastest"])
