"""Readings for a cell's limits: the program's and its control's, in one process.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...] [--out <file.jsonl>]

For each seed it runs the cell once at its own load for a short window, as
``portbench.run`` does, and prints (and appends to ``--out``) one JSON line
with every number its family compares and the end-to-end metrics.
``--control-seeds`` run the control instead: the program built by the
configuration's family with ``quantize=True``, the family's next precision
below the configuration's (for Depth Pro, the ViTs' block matmul weights as
int8 codes with per-channel scales, below bf16). The limits in
``portbench/limits/<cell>.json`` are set above the program's largest reading
and below the control's smallest. The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import time

from portbench import run
from portbench.correct import names_of
from portbench.lifecycle import Teardown


def reading(man: dict, name: str, seed: int, seconds: float, control: bool) -> dict:
    cell, config, traffic = run.cell_files(man, name)
    family = run.family_of(config)
    ctx = run.Ctx(name, cell, config, traffic, family.arch_of(config), seed, seconds, False,
                  int(cell["chips"]), "cuda", Teardown(), time.perf_counter(), control)
    no_limits = {n: float("inf") for n in names_of(family.YIELDS)}
    try:
        result, each = run.run_cell(ctx, man, limits=no_limits)
    finally:
        report = ctx.teardown.run()
    return {"workload": name, "seed": seed, "control": control,
            "compared": {k: v["value"] for k, v in result["compared"].items()},
            "each": each,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "memory_peak_bytes": result["device"]["memory_peak_bytes"],
            "survivors": report["survivors"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    man = run.manifest()
    for seed, control in [(s, False) for s in args.seeds] + [(s, True)
                                                              for s in args.control_seeds]:
        line = json.dumps(reading(man, args.workload, seed, args.seconds, control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
