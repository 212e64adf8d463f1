"""A traced slice of the window: ``torch.profiler`` on the card, read back.

``capture()`` profiles CPU ops (with their input shapes) and the device's
kernels, copies and memsets, exports the Chrome trace under ``TMPDIR``, reads
it and deletes it. ``Slice`` then holds, inside a window that starts at one
batch's upload (a host-to-device copy of exactly the batch's bytes) and ends
at the upload ``n`` batches later, so that it holds whole batches:

- the device's busy time (the union of its events) and the window's length;
- each device event, and for each kernel the ``depth_pro::`` operator whose
  host range launched it (by the launch call's correlation id), so that a
  hand-written kernel's time is read under its operator and not by name;
- each call of a ``depth_pro::`` operator with its input shapes;
- the idle gaps, each named by the host ops running in it.

The kernel groups are those of ``scripts/torch_slice_profile.py``.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# first match wins: cuDNN conv kernels contain "gemm" too, so convs come first
GROUPS = [
    ("K3 biased attention", r"attention_(bf16|fp32|wgmma)_kernel<\d+, true[,>]"),
    ("K1 attention", r"attention_(bf16|fp32|wgmma)_kernel"),
    ("K2 resblock", r"resblock_(wgmma_)?kernel"),
    ("collective (NCCL)", r"nccl"),
    ("conv (cuDNN)", r"conv|fprop|dgrad|wgrad|cudnn"),
    ("GEMM (cuBLAS)", r"nvjet|gemm|cutlass|xmma"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("GELU", r"gelu|GeluCUDA"),
    ("copy / cast", r"copy|Copy|Memcpy|memcpy|Memset|memset|cat_|CatArray"),
    ("sort / scatter / gather", r"[Ss]ort|scatter|gather|index"),
    ("reduce", r"reduce|Reduce"),
    ("other elementwise", r"elementwise|vectorized|unrolled"),
]


def group_of(name: str) -> str:
    for label, pattern in GROUPS:
        if re.search(pattern, name):
            return label
    return "other"


def busy_in(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def gaps_in(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end and end < hi:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return out


@dataclasses.dataclass
class Kernel:
    name: str
    start: float  # seconds on the trace's clock
    dur: float
    category: str
    call: int | None = None  # the depth_pro:: operator call that launched it


@dataclasses.dataclass
class Slice:
    window_s: float
    busy_s: float
    batches: int
    frames: int
    events: list           # Kernel, inside the window
    calls: list            # (op name, input dims, kernel seconds) of calls whose kernels ran inside
    gaps: list             # (seconds, host label)

    def group_seconds(self) -> dict:
        out: dict = defaultdict(float)
        for e in self.events:
            if e.category == "kernel":
                out[group_of(e.name)] += e.dur
        return dict(out)

    def top_ops(self, n: int = 10) -> list:
        by: dict = defaultdict(float)
        for e in self.events:
            by[e.name] += e.dur
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        by: dict = defaultdict(float)
        for seconds, label in self.gaps:
            by[label] += seconds
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


MIN_GAP_US = 20.0  # shorter idle stretches are summed as one label


def _label_gaps(stretches, cpu_ops) -> list:
    """(seconds, label) per idle stretch: the outermost host op running on
    each thread at its middle, or one label for all short stretches."""
    short = sum(g1 - g0 for g0, g1 in stretches if g1 - g0 < MIN_GAP_US)
    long = sorted((0.5 * (g0 + g1), g1 - g0) for g0, g1 in stretches if g1 - g0 >= MIN_GAP_US)
    marks = []
    for e in cpu_ops:
        s = float(e["ts"])
        marks.append((s, 1, id(e), e))
        marks.append((s + float(e.get("dur", 0)), 0, id(e), e))
    marks.sort(key=lambda m: (m[0], m[1]))
    active: dict = {}
    out, j = [], 0
    for mid, length in long:
        while j < len(marks) and marks[j][0] <= mid:
            _, opening, key, e = marks[j]
            if opening:
                active[key] = e
            else:
                active.pop(key, None)
            j += 1
        outer: dict = {}
        for e in active.values():
            tid = e.get("tid")
            if tid not in outer or float(e["ts"]) < float(outer[tid]["ts"]):
                outer[tid] = e
        names = sorted({e["name"] for e in outer.values()})
        out.append((length / 1e6, " + ".join(names[:3]) or "no host op"))
    if short:
        out.append((short / 1e6, f"idle stretches under {MIN_GAP_US:g} us"))
    return out


def _op_index(cpu_ops):
    """Per thread, the depth_pro:: op ranges sorted by start."""
    per: dict = defaultdict(list)
    for e in cpu_ops:
        if e["name"].startswith("depth_pro::"):
            s = float(e["ts"])
            per[e.get("tid")].append((s, s + float(e.get("dur", 0)), e))
    return {tid: (sorted(v, key=lambda r: r[0]), [r[0] for r in sorted(v, key=lambda r: r[0])])
            for tid, v in per.items()}


def read(trace: dict, marker_bytes: int, frames_per_batch: int,
         max_batches: int | None = None) -> Slice | None:
    """The slice of ``trace`` (a Chrome trace dict) between the first upload
    of ``marker_bytes`` and the last one (or ``max_batches`` later); None when
    fewer than two such uploads ran."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATEGORIES]
    marks = sorted(float(e["ts"]) for e in dev if e.get("cat") == "gpu_memcpy"
                   and "HtoD" in e.get("name", "")
                   and int((e.get("args") or {}).get("bytes", -1)) == marker_bytes)
    if len(marks) < 2:
        return None
    n = len(marks) - 1 if max_batches is None else min(max_batches, len(marks) - 1)
    lo, hi = marks[0], marks[n]
    cpu_ops = [e for e in evs if e.get("cat") == "cpu_op"]
    launches = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
    ops = _op_index(cpu_ops)
    call_ids: dict = {}
    calls: list = []
    inside: list = []
    intervals = []
    spans_out: dict = defaultdict(bool)
    for e in dev:
        s = float(e["ts"])
        d = float(e.get("dur", 0))
        k = Kernel(e.get("name", ""), s / 1e6, d / 1e6, e["cat"])
        if e["cat"] == "kernel":
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is not None and launch[1] in ops:
                rows, starts = ops[launch[1]]
                # the operators do not nest: only the last one to start can hold it
                i = bisect.bisect_right(starts, launch[0]) - 1
                if i >= 0 and rows[i][1] >= launch[0]:
                    op = rows[i][2]
                    key = id(op)
                    if key not in call_ids:
                        call_ids[key] = len(calls)
                        calls.append([op["name"], (op.get("args") or {}).get("Input Dims"), 0.0])
                    k.call = call_ids[key]
        if s >= lo and s < hi:
            inside.append(k)
            intervals.append((s, min(s + d, hi)))
            if k.call is not None:
                calls[k.call][2] += k.dur
        elif k.call is not None:
            spans_out[k.call] = True
    kept = [tuple(c) for i, c in enumerate(calls) if not spans_out[i] and c[2] > 0]
    busy = busy_in(intervals, lo, hi)
    frames = n * frames_per_batch
    gaps = _label_gaps(gaps_in(intervals, lo, hi), cpu_ops)
    return Slice(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6, batches=n, frames=frames,
                 events=inside, calls=kept, gaps=gaps)


class Capture:
    """``start()`` profiles from here, ``stop()`` ends it; ``result()``
    exports and reads the Chrome trace afterwards (outside the window)."""

    def __init__(self):
        self._prof = None
        self.running = False

    def start(self) -> "Capture":
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts, record_shapes=True)
        self._prof.start()
        self.running = True
        return self

    def stop(self) -> None:
        if self.running:
            self._prof.stop()
            self.running = False

    def result(self) -> dict:
        self.stop()
        fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)
        finally:
            os.unlink(path)
            self._prof = None
