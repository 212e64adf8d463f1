"""The port's data feed (``train/data.py``) and synthetic scenes
(``utils/synthetic.py``) against the JAX package's, bit for bit: the same
files written, the same arrays decoded, the same shuffled order, skip,
zero-substitution, remainder handling, focal scaling and abandoned producer
(the cases of ``tests/test_train.py``, run through both packages)."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from ml_depth_pro_video_tpu.train.data import DepthDataset as JDataset
from ml_depth_pro_video_tpu.utils import synthetic as jsyn
from ml_depth_pro_video_tpu_torch.train.data import DepthDataset as TDataset
from ml_depth_pro_video_tpu_torch.utils import synthetic as tsyn

ROOT = Path(__file__).resolve().parents[1]


def _pairs(root, n, size=(40, 60), seed=0, npz_focal=None):
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.random(size + (3,)) * 255).astype(np.uint8)).save(root / f"s{i}.png")
        d = rng.uniform(1, 10, size).astype(np.float32)
        d[: size[0] // 4, : size[1] // 4] = 0.0  # a hole
        if npz_focal is not None and i % 2:
            np.savez(root / f"s{i}_depth.npz", depth=d, focallength_px=np.float32(npz_focal))
        else:
            np.save(root / f"s{i}_depth.npy", d)


def _same_stream(jgen, tgen):
    jb, tb = list(jgen), list(tgen)
    assert len(jb) == len(tb)
    for (jx, jd), (tx, td) in zip(jb, tb):
        assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float32
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    return tb


@pytest.mark.parametrize("family", sorted(jsyn.FAMILIES))
def test_scene_families_equal_jax(family):
    for seed in (0, 5):
        ji, jd = jsyn.FAMILIES[family](np.random.default_rng(seed), 96)
        ti, td = tsyn.FAMILIES[family](np.random.default_rng(seed), 96)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)


def test_write_dataset_equals_jax(tmp_path):
    jsyn.write_dataset(str(tmp_path / "j"), 4, seed=2, size=64, families=("boxes", "edges"))
    tsyn.write_dataset(str(tmp_path / "t"), 4, seed=2, size=64, families=("boxes", "edges"))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir()) and len(names) == 8
    for name in names:
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name


def test_tome_deviation_curves_equal_jax():
    """The port's curves on the checked-in proxy weights against JAX's, one
    scene per family (bf16 on both sides: the deviation statistics within
    2e-2 absolute, a bf16 forward's rounding on each side of the merge)."""
    import chip_smoke
    from ml_depth_pro_video_tpu.ckpt.convert import load_params as jload
    from ml_depth_pro_video_tpu_torch.ckpt.params import from_numpy_tree, load_params

    proxy = ROOT / "tests" / "fixtures" / "tome_proxy_weights.npz"
    want = jsyn.tome_deviation_curves(jax.tree.map(np.asarray, jload(str(proxy))), n_eval=1)
    got = tsyn.tome_deviation_curves(from_numpy_tree(load_params(str(proxy))),
                                     chip_smoke.tome_proxy_config(), n_eval=1)
    assert sorted(got) == sorted(want)
    for key in want:
        for stat in ("mean", "p95", "max"):
            assert np.isfinite(got[key][stat])
            np.testing.assert_allclose(got[key][stat], want[key][stat], atol=2e-2,
                                       err_msg=f"{key} {stat}")


def test_dataset_arrays_and_shuffle_order_equal_jax(tmp_path):
    _pairs(tmp_path, 5)
    j, t = JDataset(str(tmp_path), 32, seed=3), TDataset(str(tmp_path), 32, seed=3)
    assert t.pairs == j.pairs and len(t) == 5
    for i in range(5):
        (jx, jd), (tx, td) = j._load(i), t._load(i)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(td, jd)
    batches = _same_stream(j.batches(2, epochs=3), t.batches(2, epochs=3))
    assert len(batches) == 6  # 2 per epoch, the remainder dropped
    assert batches[0][0].shape == (2, 32, 32, 3) and batches[0][1].shape == (2, 32, 32)
    assert float(batches[0][0].abs().max()) <= 1.0


def test_skip_replays_the_stream_without_decoding(tmp_path, monkeypatch):
    _pairs(tmp_path, 6, seed=1)
    full = list(TDataset(str(tmp_path), 16, seed=4).batches(2, epochs=2))
    t = TDataset(str(tmp_path), 16, seed=4)
    calls = []
    real = t._load
    monkeypatch.setattr(t, "_load", lambda i: calls.append(i) or real(i))
    resumed = list(t.batches(2, epochs=2, skip=4))
    assert len(resumed) == 2 and len(calls) == 4  # 2 batches decoded, 4 skipped undecoded
    for (a, b), (c, d) in zip(resumed, full[4:]):
        assert torch.equal(a, c) and torch.equal(b, d)
    _same_stream(JDataset(str(tmp_path), 16, seed=4).batches(2, epochs=2, skip=3),
                 TDataset(str(tmp_path), 16, seed=4).batches(2, epochs=2, skip=3))


def test_remainder_kept_and_padded_like_jax(tmp_path):
    _pairs(tmp_path, 5, seed=2)
    batches = _same_stream(JDataset(str(tmp_path), 16).batches(2, drop_remainder=False),
                           TDataset(str(tmp_path), 16).batches(2, drop_remainder=False))
    assert [b[0].shape[0] for b in batches] == [2, 2, 1]


@pytest.mark.parametrize("zero_substitute", [False, True])
def test_unreadable_pair_padded_or_zero_substituted_like_jax(tmp_path, zero_substitute):
    _pairs(tmp_path, 4, size=(16, 16), seed=5)
    j, t = JDataset(str(tmp_path), 16, seed=0), TDataset(str(tmp_path), 16, seed=0)
    Path(t.pairs[2][0]).write_bytes(b"corrupt")
    batches = _same_stream(j.batches(4, zero_substitute=zero_substitute),
                           t.batches(4, zero_substitute=zero_substitute))
    assert len(batches) == 1 and batches[0][0].shape == (4, 16, 16, 3)
    zero_rows = [i for i in range(4) if float(batches[0][1][i].abs().sum()) == 0.0]
    assert len(zero_rows) == 1


def test_focal_scaling_and_hole_aware_resize_equal_jax(tmp_path):
    _pairs(tmp_path, 4, size=(32, 64), seed=3, npz_focal=32.0)
    j, t = JDataset(str(tmp_path), 16), TDataset(str(tmp_path), 16)
    for i in range(4):
        jd, td = j._load(i)[1], t._load(i)[1]
        np.testing.assert_array_equal(td, jd)
        mid = (td > 1e-6) & (td < 0.99)  # no hole bleeds into a small positive depth
        assert not mid.any()
    # w / f_px = 64 / 32: the npz pairs come out at twice the npy pairs' depth
    a, b = t._load(1)[1], t._load(0)[1]
    assert (a > 0).any() and not np.array_equal(a, b)


def test_producer_exits_when_the_consumer_abandons(tmp_path):
    _pairs(tmp_path, 8, size=(16, 16), seed=6)
    t = TDataset(str(tmp_path), 16)
    before = set(threading.enumerate())
    gen = t.batches(2, epochs=50, prefetch=1)  # 200 batches pending
    next(gen)
    gen.close()
    deadline = time.monotonic() + 10.0
    leaked = []
    while time.monotonic() < deadline:
        leaked = [th for th in set(threading.enumerate()) - before if th.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, leaked


def test_batches_go_to_the_device_asked_for(tmp_path):
    _pairs(tmp_path, 2, size=(16, 16))
    xs, ds = next(TDataset(str(tmp_path), 16).batches(2, device="cpu"))
    assert xs.device.type == "cpu" and ds.device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(local_rows=[0]), dict(assemble=lambda a: a)])
def test_local_rows_and_assemble_go_together(tmp_path, kw):
    _pairs(tmp_path, 2, size=(16, 16))
    with pytest.raises(ValueError, match="must be given together"):
        next(TDataset(str(tmp_path), 16).batches(2, **kw))


def test_local_rows_equal_the_global_batch_rows(tmp_path):
    """Each rank's rows (``local_rows`` + ``assemble``) equal those rows of the
    global batch, as the JAX package's decode gives them: every batch of two
    epochs of 5 pairs at batch 3 (the last of each epoch short: its rows past
    the end are zero-depth), a skip, and an unreadable pair zero-substituted."""
    _pairs(tmp_path, 5, size=(16, 16))
    (tmp_path / "s2.png").write_bytes(b"not a png")
    kw = dict(epochs=2, drop_remainder=False, zero_substitute=True)
    full = list(TDataset(str(tmp_path), 16, seed=4).batches(3, **kw))
    jax_rows = {}
    for rows in ([0], [1, 2], [2]):
        mine = list(TDataset(str(tmp_path), 16, seed=4).batches(
            3, local_rows=rows, assemble=lambda a: a * 1, **kw))
        jmine = list(JDataset(str(tmp_path), 16, seed=4).batches(
            3, local_rows=rows, assemble=np.asarray, **kw))
        jax_rows[tuple(rows)] = jmine
        assert len(mine) == len(full) == len(jmine) == 4
        for (x, d), (fx, fd), (jx, jd) in zip(mine, full, jmine):
            np.testing.assert_array_equal(x.numpy(), jx)
            np.testing.assert_array_equal(d.numpy(), jd)
            n = fx.shape[0]
            for k, r in enumerate(rows):
                if r < n:
                    np.testing.assert_array_equal(x[k].numpy(), fx[r].numpy())
                    np.testing.assert_array_equal(d[k].numpy(), fd[r].numpy())
                else:  # a row past a short batch's end
                    assert not d[k].any()
    skipped = list(TDataset(str(tmp_path), 16, seed=4).batches(
        3, local_rows=[1], assemble=lambda a: a, skip=2, **kw))
    assert len(skipped) == 2
    np.testing.assert_array_equal(skipped[0][1].numpy(), full[2][1][1:2].numpy())


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TDataset(str(tmp_path), 16)


def test_profiling_utilities_match_jax_and_trace_on_the_cpu(tmp_path):
    """``ETAReporter`` as the JAX package's; ``device_trace`` writes a
    ``torch.profiler`` trace of what runs inside it, a ``span`` opened
    there included."""
    import json

    from ml_depth_pro_video_tpu.utils import profiling as jprof
    from ml_depth_pro_video_tpu_torch.utils import profiling as tprof

    eta = tprof.ETAReporter(4)
    assert eta.step().startswith("[1/4] avg ") and jprof.ETAReporter(4).step().startswith("[1/4]")
    with tprof.device_trace(str(tmp_path / "trace")):
        with tprof.span("depth_stream.stage", 5):
            torch.ones(8).sum()
    (written,) = (tmp_path / "trace").glob("*.pt.trace.json")
    events = json.loads(written.read_text())["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e.get("name") == "depth_stream.stage#5"
               for e in events)
    assert any(e.get("name") == "aten::sum" for e in events)
