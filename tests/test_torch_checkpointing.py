"""The port's training-state checkpoints (``ckpt/checkpointing.py``, which
stores ``TrainState.to_dict()``): the round trip of every part of the state, ``latest_step``, ``max_to_keep``, the
no-op save of the latest step, the atomic write, and a resumed ``fit`` equal to
an uninterrupted one bit for bit (the port alone: the JAX package's orbax
files are another format)."""

import os
import shutil

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu_torch.ckpt import checkpointing as ck
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.train import loop as tloop
from ml_depth_pro_video_tpu_torch.train.step import TrainState, make_optimizer, tree_leaves
from ml_depth_pro_video_tpu_torch.utils.synthetic import write_dataset


def _state(step=7, grad_accum=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((2, 3), generator=g).requires_grad_(),
              "blocks": [{"b": torch.randn(4, generator=g).requires_grad_()}, None]}
    opt = make_optimizer(1e-3, grad_accum=grad_accum)
    state = TrainState(params, opt.init(params), step)
    grads = [torch.randn(t.shape, generator=g) for t in tree_leaves(params)]
    opt.update(grads, state.opt_state, params)
    return state


def _equal(a: TrainState, b: TrainState) -> bool:
    oa, ob = a.opt_state, b.opt_state
    tensors = list(zip(tree_leaves(a.params), tree_leaves(b.params))) + list(
        zip(oa.mu, ob.mu)) + list(zip(oa.nu, ob.nu)) + list(zip(oa.acc or [], ob.acc or []))
    return (a.step == b.step and oa.count == ob.count and oa.mini_step == ob.mini_step
            and (oa.acc is None) == (ob.acc is None)
            and all(torch.equal(x, y) for x, y in tensors))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_round_trip_keeps_every_part_of_the_state(tmp_path, grad_accum):
    state = _state(grad_accum=grad_accum)
    assert state.opt_state.count == (1 if grad_accum == 1 else 0)
    ck.save_train_state(str(tmp_path), state.to_dict(), state.step)
    assert ck.latest_step(str(tmp_path)) == 7
    back = TrainState.from_dict(ck.restore_train_state(str(tmp_path)))
    assert _equal(back, state)
    assert all(t.requires_grad for t in tree_leaves(back.params))
    assert back.params["blocks"][1] is None
    assert back.opt_state.mini_step == state.opt_state.mini_step == (grad_accum - 1)


def test_a_plain_state_round_trips(tmp_path):
    """The store knows no training types: any nest of dicts, lists, tensors,
    ints and None comes back as it was saved."""
    state = {"a": torch.arange(6.0).reshape(2, 3), "n": 3, "l": [torch.ones(2), None]}
    ck.save_train_state(str(tmp_path), state, 11)
    back = ck.restore_train_state(str(tmp_path))
    assert back.keys() == state.keys() and back["n"] == 3 and back["l"][1] is None
    assert torch.equal(back["a"], state["a"]) and torch.equal(back["l"][0], state["l"][0])


def test_latest_step_and_restore_of_an_empty_directory(tmp_path):
    assert ck.latest_step(str(tmp_path / "missing")) is None
    assert ck.restore_train_state(str(tmp_path / "missing")) is None
    (tmp_path / "junk").mkdir()
    (tmp_path / "5").mkdir()  # a step directory without its state file does not count
    assert ck.latest_step(str(tmp_path)) is None


def test_max_to_keep_deletes_the_oldest_steps(tmp_path):
    for step in (1, 2, 3, 4, 5):
        ck.save_train_state(str(tmp_path), _state(step=step).to_dict(), step, max_to_keep=3)
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    assert ck.latest_step(str(tmp_path)) == 5
    back = ck.restore_train_state(str(tmp_path), step=4)
    assert back["step"] == 4


def test_saving_the_latest_step_again_is_a_no_op(tmp_path):
    first = _state(step=3, seed=1)
    ck.save_train_state(str(tmp_path), first.to_dict(), 3)
    path = tmp_path / "3" / ck.STATE_FILE
    before = (path.stat().st_mtime_ns, path.read_bytes())
    ck.save_train_state(str(tmp_path), _state(step=3, seed=2).to_dict(), 3)
    assert (path.stat().st_mtime_ns, path.read_bytes()) == before
    assert _equal(TrainState.from_dict(ck.restore_train_state(str(tmp_path))), first)


def test_a_failed_save_leaves_no_step_and_no_temporary(tmp_path, monkeypatch):
    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", fail)
    with pytest.raises(OSError, match="disk full"):
        ck.save_train_state(str(tmp_path), _state(step=2).to_dict(), 2)
    assert os.listdir(tmp_path) == [] and ck.latest_step(str(tmp_path)) is None


def test_restore_onto_a_given_device(tmp_path):
    ck.save_train_state(str(tmp_path), _state().to_dict(), 7)
    back = TrainState.from_dict(ck.restore_train_state(str(tmp_path), device="cpu"))
    assert all(t.device.type == "cpu" for t in tree_leaves(back.params) + back.opt_state.mu)


def test_resumed_fit_equals_an_uninterrupted_one(tmp_path):
    """An uninterrupted fit saves every step; a second fit started from a copy
    of its step-2 checkpoint replays the stream (skipping two batches
    undecoded) and must end on the same state bit for bit."""
    data = tmp_path / "data"
    write_dataset(str(data), 4, seed=5, size=64)
    kw = dict(cfg=tiny_config(), batch_size=2, epochs=2, lr=1e-3, warmup_steps=1,
              precision=Precision.fp32(), save_every=1, log_every=1, device="cpu")
    full = tloop.fit(str(data), checkpoint_dir=str(tmp_path / "full"), **kw)
    assert full.step == 4 and sorted(os.listdir(tmp_path / "full")) == ["2", "3", "4"]
    shutil.copytree(tmp_path / "full" / "2", tmp_path / "resumed" / "2")
    resumed = tloop.fit(str(data), checkpoint_dir=str(tmp_path / "resumed"), **kw)
    assert resumed.step == 4
    assert _equal(resumed, full)
    assert not np.array_equal(tree_leaves(full.params)[0].detach().numpy(),
                              tree_leaves(ck.restore_train_state(
                                  str(tmp_path / "full"), step=2)["params"])[0].numpy())
