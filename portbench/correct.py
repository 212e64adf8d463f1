"""How a run's ``correct`` is decided.

Once the window has closed and the program's state is freed, the plain
reference of the configuration's family (``reference_answers`` of
``portbench/families/<family>.py``; for Depth Pro,
``portbench/reference/depth_pro.py``) runs on the inputs behind a seeded
sample of the answers the timed path gave in the window, with weights made
again from the seed, once in the configuration's precision and once in fp32.
The family says what a sample key's input is (for Depth Pro, one frame) and
what an answer yields for comparison (``arrays``): ``inverse_depth`` always,
and ``focallength_px`` where the family has one (``YIELDS``). Of each answer
it reads:

- ``depth_rel``: the L2 distance of the answer's inverse depth from the
  reference's, in units of the distance between the reference's own
  inverse depths in the configuration's precision and in fp32, summed over
  the sample before the division;
- ``depth_gap``: that distance over the L2 norm of the reference's inverse
  depth; ``depth_p50_gap``: the median over pixels of the distance over the
  mean inverse depth, each averaged over the sample;
- where the family yields f_px: ``fpx_gap``, the relative error of f_px,
  averaged over the sample; ``fpx_rel``, the f_px error in units of the
  reference's own error against fp32, summed over the sample before the
  division. A family without f_px has neither number, and a limits file
  that names one fails when it loads.

A cell compares the numbers its limits file (``portbench/limits/<cell>.json``)
names, with the readings they were set from; the others are logged beside
them. Depth Pro's cells compare ``depth_rel``: how far bf16 drifts from fp32
depends on the weights (one seed's answers all lay 0.0065 from the reference
in ``depth_gap`` where others lay 0.0015-0.0028), and the program's distance
moves with it, so that ``depth_rel`` read 0.91-1.02 on every seed while the
int8 control read 5.5-7.8. Inverse depth is what the models compute: Depth
Pro's depth itself is clamped at 1e4 m where the inverse is near 0. A
missing, non-finite or misshapen answer reads as infinitely far.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

NAMES = ("depth_gap", "depth_p50_gap", "fpx_gap", "depth_rel", "fpx_rel")
FPX_NAMES = ("fpx_gap", "fpx_rel")  # read only where the family yields focallength_px


def names_of(yields) -> tuple:
    """The numbers a family that yields the arrays ``yields`` has, in ``NAMES``'s order."""
    return tuple(n for n in NAMES if n not in FPX_NAMES or "focallength_px" in yields)


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


def parts(got: dict | None, ref: dict, ref32: dict) -> dict | None:
    """The pieces of the compared numbers for one answer's arrays (``got``:
    ``inverse_depth`` (H, W), and ``focallength_px`` where the family yields
    it) against the reference's in the configuration's precision (``ref``)
    and in fp32 (``ref32``); None for a missing, non-finite or misshapen
    answer."""
    if got is None:
        return None
    ref_inv = ref["inverse_depth"]
    inv = got["inverse_depth"]
    if inv.shape != ref_inv.shape or not np.isfinite(inv).all():
        return None
    diff = np.abs(inv - ref_inv)
    out = {"diff": float(np.linalg.norm(diff)), "size": float(np.linalg.norm(ref_inv)),
           "yard": float(np.linalg.norm(ref32["inverse_depth"] - ref_inv)),
           "p50": float(np.median(diff) / np.abs(ref_inv).mean())}
    if "focallength_px" in ref:
        f_px = got["focallength_px"]
        if not math.isfinite(f_px):
            return None
        f_ref = ref["focallength_px"]
        out.update(fdiff=abs(f_px - f_ref), f=abs(f_ref),
                   fyard=abs(ref32["focallength_px"] - f_ref))
    return out


def numbers(pieces: list, names: tuple = NAMES) -> dict:
    """The compared numbers ``names`` of a sample from its answers' pieces."""
    if not pieces or any(p is None for p in pieces):
        return {n: math.inf for n in names}
    n = len(pieces)

    def total(key):
        return sum(p[key] for p in pieces)

    got = {"depth_gap": sum(p["diff"] / p["size"] for p in pieces) / n,
           "depth_p50_gap": total("p50") / n,
           "depth_rel": total("diff") / max(total("yard"), 1e-30)}
    if "fpx_gap" in names:
        got.update(fpx_gap=sum(p["fdiff"] / p["f"] for p in pieces) / n,
                   fpx_rel=total("fdiff") / max(total("fyard"), 1e-30))
    return {name: got[name] for name in names}


def load_limits(root: Path, cell: str) -> dict:
    """The limits of the numbers the cell compares. A limit on a number that
    the cell's family does not yield is refused."""
    from .run import cell_files, family_name, family_of, manifest

    _, config, _ = cell_files(manifest(root), cell, root)
    have = names_of(family_of(config, root).YIELDS)
    data = json.loads((root / "portbench" / "limits" / f"{cell}.json").read_text())
    alien = [n for n in NAMES if n in data and n not in have]
    if alien:
        raise ValueError(f"portbench/limits/{cell}.json sets a limit on {', '.join(alien)}, which "
                         f"the family {family_name(config)!r} does not yield (it has "
                         f"{', '.join(have)})")
    return {n: float(data[n]) for n in NAMES if n in data}


def answer_arrays(family, answer) -> dict | None:
    """``family.arrays(answer)``; None for a missing or malformed answer."""
    try:
        got = family.arrays(answer)
    except (TypeError, KeyError, ValueError):
        return None
    return got if set(got) == set(family.YIELDS) else None


def judge(samples: list, refs: dict, limits: dict, family) -> tuple[bool, dict, dict]:
    """``samples``: (sample key, answer) pairs; ``refs``: sample key ->
    (the reference's answer in the configuration's precision, in fp32);
    ``limits``: the numbers compared; ``family``: the configuration's family
    module. Returns (correct, {name: {"value", "limit"}}, {name: each
    answer's number}); an empty sample is not correct."""
    names = names_of(family.YIELDS)
    pieces = [parts(answer_arrays(family, answer), *map(family.arrays, refs[key]))
              for key, answer in samples]
    values = numbers(pieces, names)
    each = {n: [numbers([p], names)[n] for p in pieces] for n in names}
    compared = {n: {"value": values[n], "limit": limit} for n, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared, each
