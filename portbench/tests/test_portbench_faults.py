"""A run with the timed path broken underneath reads ``correct`` false.

Each case drives the rest of a run at a tiny preset on the CPU (the look for
a card skipped) with the cell's own limits, and plants one fault in the
program where the answers are produced (``DepthVideoRunner._infer``, which
the stream calls for every batch): half of the batch left out
and the mean of the rest given in its place; an answer altered (each frame
given its neighbour's depth); a step that returns its state unchanged (every
batch given the first batch's answers). The case without a fault reads
``correct`` true.
"""

from __future__ import annotations

import pytest
import torch

from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from portbench.correct import load_limits
from portbench.tests.tiny import ROOT, run_tiny


def half_batch(out):
    half = max(out["depth"].shape[0] // 2, 1)
    return {k: torch.cat([v[:half], v[:half].mean(0, keepdim=True).expand_as(v[half:])])
            for k, v in out.items()}


def neighbours(out):
    return {k: v.roll(1, 0) for k, v in out.items()}


FAULTS = {"none": None, "half_batch": half_batch, "neighbours_answer": neighbours,
          "unchanged_state": "first"}
CELLS = ["video_large_b8", "video_fast_b8"]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_fails_the_run(monkeypatch, cell, fault):
    plant = FAULTS[fault]
    if plant is not None:
        infer = DepthVideoRunner._infer
        first = {}

        def broken(self, xs, f_arr, mixed):
            out = infer(self, xs, f_arr, mixed)
            if plant == "first":
                return first.setdefault("out", {k: v.clone() for k, v in out.items()})
            return plant(out)

        monkeypatch.setattr(DepthVideoRunner, "_infer", broken)
    result, report = run_tiny(cell, load_limits(ROOT, cell), seconds=2.0)
    assert report["survivors"] == []
    assert result is not None
    assert result["correct"] is (plant is None), result["compared"]
