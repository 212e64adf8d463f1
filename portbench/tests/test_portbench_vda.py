"""The ``video_vda_large_w32`` cell at a tiny size on the CPU, through the
harness as it is (``run.execute``), with the cell's own limits.

The tiny model has the cell's window, keyframes and temporal heads, and a
ViT 64 wide with 4 blocks on 40x60 frames (a 2x3 grid). Without a fault the
run reads ``correct`` true; with either planted fault it reads false:

- temporal attention along the wrong axis (each temporal module attends
  along the frame's rows instead of the window's frames);
- a wrong keyframe carried (the runner carries the window before's input at
  position 1 where upstream carries position 0, the stream's first frame).

Also: the configuration's FLOPs are the published shapes', and the readers
of the cell's per-layer metrics read a hand-built slice.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import pytest

from portbench import run
from portbench.correct import load_limits
from portbench.lifecycle import Teardown
from portbench.tests.tiny import ROOT

CELL = "video_vda_large_w32"
TINY = {"patch_size": 14, "embed_dim": 64, "depth": 4, "num_heads": 2, "mlp_ratio": 2,
        "pretrain_size": 28, "intermediate_layer_idx": [0, 1, 2, 3], "features": 64,
        "out_channels": [32, 64, 64, 64], "head_features_2": 8, "input_size": 28}
FRAMES = {"height": 40, "width": 60, "pool": 40, "warmup_windows": 2, "sample": 8}


def tiny_run(seed: int = 2 ** 31 + 11, seconds: float = 1.0):
    man = run.manifest(ROOT)
    entry, config, mix = run.cell_files(man, CELL, ROOT)
    config = copy.deepcopy(config)
    config["model"].update(TINY)
    config["assumed"]["frame_size"] = [FRAMES["height"], FRAMES["width"]]
    mix = {**mix, **FRAMES}
    family = run.family_of(config, ROOT)
    ctx = run.Ctx(CELL, entry, config, mix, family.arch_of(config), seed, seconds, False, 1,
                  "cpu", Teardown(), time.perf_counter())
    return run.execute(ctx, man, ROOT, load_limits(ROOT, CELL))


def wrong_axis(monkeypatch):
    from ml_depth_pro_video_tpu_torch.models import video_depth_anything as vda

    apply = vda.temporal_apply
    monkeypatch.setattr(vda, "temporal_apply", lambda p, x, *a: apply(
        p, x.permute(1, 0, 2, 3), *a).permute(1, 0, 2, 3))


def wrong_keyframe(monkeypatch):
    from ml_depth_pro_video_tpu_torch.video import runner as runner_mod

    make = runner_mod.DepthVideoRunner.__init__

    def carry_position_1(self, *a, **kw):
        make(self, *a, **kw)
        self.cfg = dataclasses.replace(self.cfg, keyframes=(1,) + self.cfg.keyframes[1:])

    monkeypatch.setattr(runner_mod.DepthVideoRunner, "__init__", carry_position_1)


FAULTS = {"none": None, "wrong_axis": wrong_axis, "wrong_keyframe": wrong_keyframe}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_run(monkeypatch, fault):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result, report = tiny_run()
    assert report["survivors"] == []
    assert result is not None
    assert set(result["compared"]) == {"depth_rel"}
    assert result["correct"] is (fault == "none"), result["compared"]


def test_published_flops():
    from portbench.flops_vda import encoder_flops, head_flops, new_frame_flops, temporal_flops
    from portbench.reference.video_depth_anything import Arch

    arch = Arch()
    assert arch.tokens == 2443
    assert encoder_flops(arch) == pytest.approx(2.065e12, rel=1e-3)
    assert head_flops(arch) == pytest.approx(0.518e12, rel=1e-3)
    assert temporal_flops(arch) == pytest.approx(0.1784e12, rel=1e-3)
    # the encoder over 22 new frames, the head and temporal modules over 32
    assert new_frame_flops(arch) * 22 == pytest.approx(
        22 * encoder_flops(arch) + 32 * (head_flops(arch) + temporal_flops(arch)))


def test_readers_split_k1_calls_by_sequence_length():
    from portbench.flops import attention_bytes, bound_s
    from portbench.reference.video_depth_anything import Arch
    from portbench.trace import Slice

    calls = [("depth_pro::attention_packed", [[32, 2443, 3072], []], 4e-3),
             ("depth_pro::attention_packed", [[9768, 32, 768], []], 1e-3),
             ("depth_pro::attention_packed", [[2442, 32, 3072], []], 2e-3),
             ("depth_pro::resblock", [[32, 37, 66, 256]], 1e-3)]
    sl = Slice(window_s=1.0, busy_s=0.9, batches=4, frames=88, events=[], calls=calls, gaps=[])
    ctx = run.MetricContext(sl, Arch())
    readers = {name: run.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", name)
               for name in ("k1_roofline.vda", "temporal_roofline.vda", "idle_share.vda",
                            "mfu.vda")}
    temporal = 100 * (bound_s(4.0 * 9768 * 32 * 32 * 256, attention_bytes(9768, 32, 256))
                      + bound_s(4.0 * 2442 * 32 * 32 * 1024, attention_bytes(2442, 32, 1024)))
    temporal /= 3e-3
    assert readers["temporal_roofline.vda"].read(ctx) == pytest.approx(temporal)
    k1 = 100 * bound_s(4.0 * 32 * 2443 ** 2 * 1024, attention_bytes(32, 2443, 1024)) / 4e-3
    assert readers["k1_roofline.vda"].read(ctx) == pytest.approx(k1)
    assert readers["idle_share.vda"].read(ctx) == pytest.approx(10.0)
    assert 0 < readers["mfu.vda"].read(ctx) < 100
    empty = run.MetricContext(None, Arch())
    assert all(r.read(empty) is None for r in readers.values())
