"""The control, the program's int8 path (``quantize=True``), through the
harness: at the cells' own size on the card it reads above each cell's limit
(the limits' upper readings came from three seeds of it); at a tiny preset on
the CPU, where the program runs its plain path, it reads further from the
reference than the program does."""

from __future__ import annotations

import pytest
import torch

from portbench.correct import load_limits
from portbench.tests.tiny import ROOT, run_tiny

CELLS = ["video_large_b8", "video_fast_b8"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_on_the_cpu(cell):
    program, _ = run_tiny(cell, seconds=1.0)
    control, _ = run_tiny(cell, seconds=1.0, control=True)
    assert (control["compared"]["depth_gap"]["value"]
            > program["compared"]["depth_gap"]["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is read at the cell's own size")
    from portbench import calibrate, run

    run.cache_env()
    got = calibrate.reading(run.manifest(), cell, 2500000001, 3.0, True)
    limits = load_limits(ROOT, cell)
    assert any(got["compared"][name] > limit for name, limit in limits.items()), (got, limits)
