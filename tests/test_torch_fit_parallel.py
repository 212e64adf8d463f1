"""``fit`` across ranks on the CPU (the port's twin of the JAX package's
``tests/test_multihost.py::test_two_process_train``).

Two gloo ranks run ``depth-pro-train-torch``'s ``main`` with the multi-host
flags (``--coordinator``, ``--num_processes``, ``--process_id``), once with
dp=2 and once with ``--tp 2``, on the dataset and npz a one-rank ``fit``
trains at the same global batch: per-step losses and val_silog, and the
params of the last checkpoint (one checkpoint in the one-rank layout,
written by rank 0), against the one-rank run's. Then the checkpoints cross
layouts: a one-rank ``fit`` resumes from the tp=2 checkpoint, a 2-rank
``--pp 2`` run from the one-rank checkpoint, each continued to step 4 beside
a one-rank run resumed from its own. The runs are fp32 (``fit`` is patched
to it in the ranks) on the tiny npz with the final head bias raised by 0.5
(``tests/test_torch_train.py::npz_shifted``).

The bound: a dp or tp step sums the same gradients in another order, so
the params part by rounding (3.0e-6 at most, in 3 of 524,328 elements, on
this npz and data); every param within 1e-5 of the one-rank run's, a tenth
of one Adam step (lr 1e-4), and the parameter checksum within rtol 1e-5, as
the JAX test holds it.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu_torch.ckpt.checkpointing import restore_train_state
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import depth_pro as tdp
from ml_depth_pro_video_tpu_torch.train import loop as tloop
from ml_depth_pro_video_tpu_torch.train.step import tree_leaves
from ml_depth_pro_video_tpu_torch.utils.synthetic import write_dataset
from torch_checkpoint import write_tiny_checkpoint
from torch_ranks import spawn

LR = 1e-4
STEP_ATOL = 1e-5  # a tenth of one Adam step
CHECKSUM_RTOL = 1e-5
LOSS_RTOL = 1e-5
KW = dict(batch_size=2, lr=LR, warmup_steps=1, holdout=1, log_every=1, seed=0, save_every=1)

_WORKER = r"""
import dataclasses, functools
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import depth_pro as dp
from ml_depth_pro_video_tpu_torch.train import loop
npz = args[0]
tiny = dp.tiny_config
dp.model_preset = lambda name: dataclasses.replace(tiny(), checkpoint_uri=npz)
loop.fit = functools.partial(loop.fit, precision=Precision.fp32())
loop.main(args[1:] + ["--coordinator", f"127.0.0.1:{port}", "--num_processes", str(n),
                      "--process_id", str(rank)])
assert mh.cluster() is not None and mh.world_size() == 2
print("OK", rank)
"""


def _cli(data, ckpt, metrics, epochs, *flags):
    return ["--data_root", str(data), "--tiny", "--device", "cpu", "--batch_size", "2",
            "--epochs", str(epochs), "--lr", str(LR), "--warmup_steps", "1", "--holdout", "1",
            "--log_every", "1", "--checkpoint_dir", str(ckpt), "--save_every", "1",
            "--metrics_file", str(metrics), *flags]


def _params(ckpt, step):
    return [t.numpy() for t in tree_leaves(restore_train_state(str(ckpt), step, "cpu")["params"])]


def _rows(metrics):
    return [json.loads(line) for line in metrics.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit_parallel")
    npz = write_tiny_checkpoint(str(tmp / "tiny.npz"))
    flat = dict(np.load(npz))
    flat["head/conv_out/b"] = flat["head/conv_out/b"] + np.float32(0.5)
    np.savez(npz, **flat)
    cfg = dataclasses.replace(tdp.tiny_config(), checkpoint_uri=npz)
    data = tmp / "data"
    write_dataset(str(data), 5, seed=3, size=64)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = tmp / "one"
        tloop.fit(str(data), cfg, epochs=1, precision=Precision.fp32(), device="cpu",
                  checkpoint_dir=str(one), metrics_file=str(tmp / "one.jsonl"), **KW)
        for mode, flags in (("dp", []), ("tp", ["--tp", "2"])):
            spawn(_WORKER, 2, npz, *_cli(data, tmp / mode, tmp / f"{mode}.jsonl", 1, *flags),
                  join=False, timeout=600)
        # across layouts: one rank resumes a tp=2 checkpoint, pp=2 ranks a one-rank one
        for src, dst in (("tp", "tp_then_one"), ("one", "one_then_pp"), ("one", "one_then_one")):
            shutil.copytree(tmp / src, tmp / dst)
        for dst in ("tp_then_one", "one_then_one"):
            tloop.fit(str(data), cfg, epochs=2, precision=Precision.fp32(), device="cpu",
                      checkpoint_dir=str(tmp / dst), **KW)
        spawn(_WORKER, 2, npz, *_cli(data, tmp / "one_then_pp", tmp / "pp.jsonl", 2, "--pp", "2"),
              join=False, timeout=600)
    finally:
        torch.set_num_threads(prev)
    return tmp


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_ATOL, err_msg=f"{what} leaf {i}")
    ca, cb = (sum(float(np.abs(x).sum()) for x in p) for p in (got, want))
    np.testing.assert_allclose(ca, cb, rtol=CHECKSUM_RTOL, err_msg=what)


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_two_rank_fit_equals_one_rank(runs, mode):
    """The 2-rank run's losses, val_silog and last checkpoint (the one-rank
    layout: the same shapes) against the one-rank run's."""
    got, want = _rows(runs / f"{mode}.jsonl"), _rows(runs / "one.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]  # rank 0 alone wrote rows
    for a, b in zip(got, want):
        assert a["step"] == b["step"]
        for key in ("loss", "val_silog"):
            if key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL, err_msg=key)
    assert sorted(p.name for p in (runs / mode).iterdir()) == ["1", "2"]
    _close(_params(runs / mode, 2), _params(runs / "one", 2), mode)


def test_checkpoints_cross_layouts(runs):
    """A tp=2 checkpoint restores into a one-rank fit and a one-rank
    checkpoint into a pp=2 fit: each continues to step 4, beside a one-rank
    fit that resumed its own checkpoint; the restored state is the saved one
    (a resumed run that read another step would part from it by far more)."""
    want = _params(runs / "one_then_one", 4)
    for name in ("tp_then_one", "one_then_pp"):
        _close(_params(runs / name, 4), want, name)
    rows = _rows(runs / "pp.jsonl")
    assert [r["step"] for r in rows if "loss" in r] == [3, 4]
