"""A cell at a tiny preset on the CPU, for the benchmark's own tests."""

from __future__ import annotations

import copy
import time
from pathlib import Path

from portbench import run
from portbench.lifecycle import Teardown
from portbench.reference.depth_pro import arch_of

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"preset": "tiny", "speed": "exact", "precision": "bf16", "vit_img_size": 128,
              "patch_size": 16, "embed_dim": 64, "depth": 2, "num_heads": 2, "mlp_ratio": 2,
              "decoder_features": 16, "dims_encoder": [16, 32, 64, 64],
              "hook_block_ids": [0, 1], "token_merge_ratio": 0.0, "token_merge_block": 2}
SMALL_FRAMES = {"height": 96, "width": 160}


def tiny_ctx(cell: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
             control: bool = False):
    """The cell's context with the tiny preset's shapes and small frames."""
    man = run.manifest(ROOT)
    entry, config, mix = run.cell_files(man, cell, ROOT)
    config = copy.deepcopy(config)
    config["model"] = dict(TINY_MODEL)
    mix = {**mix, **SMALL_FRAMES}
    return man, run.Ctx(cell, entry, config, mix, arch_of(config), seed, seconds, trace,
                        int(entry["chips"]),
                        "cpu", Teardown(), time.perf_counter(), control)


def run_tiny(cell: str, limits: dict | None = None, **kw) -> tuple[dict | None, dict]:
    """(the result line, or None if the run raised; the teardown's report)."""
    man, ctx = tiny_ctx(cell, **kw)
    return run.execute(ctx, man, ROOT, limits or {"depth_gap": 1e-3, "fpx_gap": 1e-3})
