"""The card's idle time split by what ``depth_stream``'s thread was doing.

``DepthVideoRunner.depth_stream`` marks its loop with five spans while a
``torch.profiler`` runs (``video/runner.py``: ``depth_stream.wait_frames``,
``.stage``, ``.launch``, ``.collect``, ``.caller``, each ``<span>#<batch>``),
as ``user_annotation`` events on the profiler's clock, the clock of the
card's kernels, copies and memsets. From a Chrome trace this script reports,
inside a window, the share of the window in which the card ran nothing
(no kernel, copy or memset) and which phase the stream's thread was in
meanwhile, and checks the shared clock: no device event starts before the
span whose host call enqueued it opened.

Two ways to run it, from the repository root:

    python3 scripts/torch_stream_spans.py TRACE.json [--marker-bytes N --batches K]

reads a saved trace (``utils/profiling.py::device_trace`` writes one);
without ``--marker-bytes`` the window runs from the first to the last device
event, with it from the first host-to-device copy of exactly N bytes (a
batch's upload) to the one K batches later, as the benchmark's slice does.

    python3 scripts/torch_stream_spans.py --workload video_large_b8 --seed 7 [--seconds 50]

runs one benchmark cell with ``--trace 1`` (``portbench/run.py``) and splits
the idle time of the slice that its per-layer metrics read, over the same
window. The benchmark's result line comes first on standard output, then
this script's JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

PREFIX = "depth_stream."
PHASES = ("wait_frames", "stage", "launch", "collect", "caller")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def stream_spans(trace: dict) -> list[tuple[str, int | None, float, float, object]]:
    """(phase, batch, start µs, end µs, thread) of every ``depth_stream.``
    host span, by start."""
    out = []
    for e in trace.get("traceEvents", []):
        name = e.get("name", "")
        if e.get("ph") != "X" or e.get("cat") != "user_annotation" or not name.startswith(PREFIX):
            continue
        phase, _, num = name[len(PREFIX):].partition("#")
        s = float(e["ts"])
        out.append((phase, int(num) if num.isdigit() else None, s, s + float(e.get("dur", 0)),
                    e.get("tid")))
    return sorted(out, key=lambda r: r[2])


def _device(trace: dict) -> list[dict]:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def window(trace: dict, marker_bytes: int | None = None,
           batches: int | None = None) -> tuple[float, float] | None:
    """[lo, hi) in µs: from the first upload of ``marker_bytes`` to the one
    ``batches`` later (or the last), or without a marker the device's
    whole span; None where that is empty."""
    dev = _device(trace)
    if marker_bytes is None:
        if not dev:
            return None
        return (min(float(e["ts"]) for e in dev),
                max(float(e["ts"]) + float(e.get("dur", 0)) for e in dev))
    marks = sorted(float(e["ts"]) for e in dev if e["cat"] == "gpu_memcpy"
                   and "HtoD" in e.get("name", "")
                   and int((e.get("args") or {}).get("bytes", -1)) == marker_bytes)
    if len(marks) < 2:
        return None
    n = len(marks) - 1 if batches is None else min(batches, len(marks) - 1)
    return marks[0], marks[n]


def _union(intervals) -> list[tuple[float, float]]:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(trace: dict, lo: float, hi: float) -> dict:
    """Percent of [lo, hi) with nothing on the card (``idle``: every device
    event that starts inside it, clipped at ``hi``, counts as busy) and, per
    phase, the part of that idle time spent in the phase's spans."""
    busy = _union((float(e["ts"]), min(float(e["ts"]) + float(e.get("dur", 0)), hi))
                  for e in _device(trace) if lo <= float(e["ts"]) < hi)
    idle, end = [], lo  # [lo, hi) less the busy set
    for s, e in busy:
        if s > end:
            idle.append((end, s))
        end = max(end, e)
    if end < hi:
        idle.append((end, hi))
    spans = stream_spans(trace)
    width = hi - lo
    out = {"window_s": width / 1e6, "idle": 100.0 * sum(b - a for a, b in idle) / width}
    for phase in PHASES:
        mine = _union((max(s, lo), min(e, hi)) for p, _, s, e, _ in spans if p == phase)
        out[phase] = 100.0 * _overlap(idle, mine) / width if mine else None
    return out


def enqueue_order(trace: dict) -> dict:
    """Per phase: device events whose host launch call ran inside one of
    the stream's spans; how many of them started on the card before that
    span opened (none may, on one shared clock), the most by which one did
    (µs), and how many started before their own launch call did (a skew
    between the card's timestamps and the host's, span or no span)."""
    launches = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
    per_tid: dict = {}
    for span in stream_spans(trace):
        per_tid.setdefault(span[4], []).append(span)
    starts = {tid: [s[2] for s in rows] for tid, rows in per_tid.items()}
    out = {p: {"events": 0, "early": 0, "most_early_us": 0.0, "before_call": 0} for p in PHASES}
    for e in _device(trace):
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None or launch[1] not in per_tid:
            continue
        i = bisect.bisect_right(starts[launch[1]], launch[0]) - 1
        if i < 0:
            continue
        phase, _, s, end, _ = per_tid[launch[1]][i]
        if launch[0] <= end and phase in out:
            row, ts = out[phase], float(e["ts"])
            row["events"] += 1
            row["early"] += ts < s
            row["most_early_us"] = max(row["most_early_us"], s - ts)
            row["before_call"] += ts < launch[0]
    return out


def report(trace: dict, marker_bytes: int | None = None, batches: int | None = None) -> dict:
    win = window(trace, marker_bytes, batches)
    if win is None:
        return {"window": None}
    split = idle_split(trace, *win)
    known = [split[p] for p in PHASES if split[p] is not None]
    split["phases_of_idle"] = 100.0 * sum(known) / split["idle"] if split["idle"] else None
    return {"split": split, "enqueue_order": enqueue_order(trace)}


def run_cell(workload: str, seed: int, seconds: float) -> tuple[int, dict]:
    """One ``--trace 1`` run of a benchmark cell, its slice's raw trace
    split over the slice's own window."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import run, trace as bench_trace

    got: dict = {}
    read = bench_trace.read

    def read_and_split(raw, marker_bytes, frames_per_batch, max_batches=None):
        got.update(report(raw, marker_bytes, max_batches))
        return read(raw, marker_bytes, frames_per_batch, max_batches)

    bench_trace.read = read_and_split
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "1"])
    return rc, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="?", help="a Chrome trace (.json)")
    ap.add_argument("--marker-bytes", type=int, default=None)
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("--workload", help="a benchmark cell, run with --trace 1")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args(argv)
    if (args.trace is None) == (args.workload is None):
        ap.error("give a trace file or --workload")
    rc = 0
    if args.workload:
        rc, got = run_cell(args.workload, args.seed, args.seconds)
        got = {"workload": args.workload, "seed": args.seed, **got}
    else:
        with open(args.trace) as f:
            got = report(json.load(f), args.marker_bytes, args.batches)
    print(json.dumps(got), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
