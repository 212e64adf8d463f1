"""How a run's ``correct`` is decided.

Once the window has closed and the program's state is freed, the plain
reference (``portbench/reference/depth_pro.py``) runs on the frames behind a
seeded sample of the answers the timed path gave in the window, with weights
made again from the seed, once in the configuration's precision and once in
fp32. Of each answer it reads:

- ``depth_rel``: the L2 distance of the answer's inverse depth from the
  reference's, in units of the distance between the reference's own bf16 and
  fp32 inverse depths, summed over the sample before the division;
- ``depth_gap``: that distance over the L2 norm of the reference's inverse
  depth; ``depth_p50_gap``: the median over pixels of the distance over the
  mean inverse depth; ``fpx_gap``: the relative error of f_px, each averaged
  over the sample; ``fpx_rel``: the f_px error in units of the reference's
  own bf16-to-fp32 error, summed over the sample before the division.

A cell compares the numbers its limits file (``portbench/limits/<cell>.json``)
names, with the readings they were set from. Today that is ``depth_rel``: how
far bf16 drifts from fp32 depends on the weights (one seed's answers all lay
0.0065 from the reference in ``depth_gap`` where others lay 0.0015-0.0028),
and the program's distance moves with it, so that ``depth_rel`` read
0.91-1.02 on every seed while the int8 control read 5.5-7.8; the other
numbers are logged beside it. Inverse depth is what the model computes: depth
itself is clamped at 1e4 m where the inverse is near 0. A missing,
non-finite or misshapen answer reads as infinitely far.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

NAMES = ("depth_gap", "depth_p50_gap", "fpx_gap", "depth_rel", "fpx_rel")


class Sampler:
    """A seeded uniform sample of ``k`` items from a stream of unknown length
    (reservoir sampling): the same seed and stream give the same sample."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 0xC0FFEE])
        self.items: list = []
        self.seen = 0

    def offer(self, key, make) -> None:
        """Offer the stream's next item: ``make()`` builds it, only if kept."""
        if len(self.items) < self.k:
            self.items.append((key, make()))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (key, make())
        self.seen += 1


def parts(answer: dict | None, ref: dict) -> dict | None:
    """The pieces of the compared numbers for one answer ({"depth": (H, W),
    "focallength_px"}) against the reference's ("depth", "focallength_px",
    and the same computed in fp32, "depth32", "focallength_px32"); None for
    a missing, non-finite or misshapen answer."""
    ref_inv = 1.0 / np.asarray(ref["depth"], np.float64)
    try:
        depth = np.asarray(answer["depth"], np.float64)
        f_px = float(answer["focallength_px"])
    except (TypeError, KeyError, ValueError):
        return None
    if depth.shape != ref_inv.shape or not np.isfinite(depth).all() or not math.isfinite(f_px):
        return None
    diff = np.abs(1.0 / depth - ref_inv)
    f_ref = float(ref["focallength_px"])
    return {"diff": float(np.linalg.norm(diff)), "size": float(np.linalg.norm(ref_inv)),
            "yard": float(np.linalg.norm(1.0 / np.asarray(ref["depth32"], np.float64) - ref_inv)),
            "p50": float(np.median(diff) / np.abs(ref_inv).mean()),
            "fdiff": abs(f_px - f_ref), "f": abs(f_ref),
            "fyard": abs(float(ref["focallength_px32"]) - f_ref)}


def numbers(pieces: list) -> dict:
    """The compared numbers of a sample from its answers' pieces."""
    if not pieces or any(p is None for p in pieces):
        return {n: math.inf for n in NAMES}
    n = len(pieces)

    def total(key):
        return sum(p[key] for p in pieces)

    return {"depth_gap": sum(p["diff"] / p["size"] for p in pieces) / n,
            "depth_p50_gap": total("p50") / n,
            "fpx_gap": sum(p["fdiff"] / p["f"] for p in pieces) / n,
            "depth_rel": total("diff") / max(total("yard"), 1e-30),
            "fpx_rel": total("fdiff") / max(total("fyard"), 1e-30)}


def load_limits(root: Path, cell: str) -> dict:
    """The limits of the numbers the cell compares."""
    data = json.loads((root / "portbench" / "limits" / f"{cell}.json").read_text())
    return {n: float(data[n]) for n in NAMES if n in data}


def reference_answers(frames: dict, weights_fn, arch, dtype, device, block: int = 2) -> dict:
    """The reference's answer for each distinct frame ({frame id: uint8
    (H, W, 3)}) in the configuration's ``dtype`` and in fp32, computed
    ``block`` frames at a time."""
    import torch

    from .reference import depth_pro as ref

    params = weights_fn()
    out = {}
    ids = sorted(frames)
    for i in range(0, len(ids), block):
        chunk = ids[i:i + block]
        x = torch.from_numpy(np.stack([frames[j] for j in chunk])).to(device)
        res = {tag: ref.infer(params, x, arch, dt)
               for tag, dt in (("", dtype), ("32", torch.float32))}
        for n, j in enumerate(chunk):
            out[j] = {f"{key}{tag}": (r[key][n].float().cpu().numpy() if key == "depth"
                                      else float(r[key][n]))
                      for tag, r in res.items() for key in ("depth", "focallength_px")}
    del params
    return out


def judge(samples: list, refs: dict, limits: dict) -> tuple[bool, dict, dict]:
    """``samples``: (frame id, answer) pairs; ``limits``: the numbers compared.
    Returns (correct, {name: {"value", "limit"}}, {name: each answer's
    number}); an empty sample is not correct."""
    pieces = [parts(answer, refs[frame_id]) for frame_id, answer in samples]
    values = numbers(pieces)
    each = {n: [numbers([p])[n] for p in pieces] for n in NAMES}
    compared = {n: {"value": values[n], "limit": limit} for n, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared, each
