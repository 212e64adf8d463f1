"""Tracing / profiling utilities.

Twin of ``ml_depth_pro_video_tpu/utils/profiling.py``: a stage timer with
running averages, an ETA reporter, and a device trace context on
``torch.profiler`` (CUDA kernels and host ops; the trace opens in
TensorBoard's profiler plugin or in Perfetto).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    """Accumulates per-stage wall-clock stats across frames."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name],
                   "avg_s": self.totals[name] / max(self.counts[name], 1)}
            for name in self.totals
        }

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:30s} {s['total_s']:8.2f}s total  {s['avg_s']*1000:8.1f}ms avg  x{s['count']}")
        return "\n".join(lines)


class ETAReporter:
    """Running average + ETA over a known item count (parity with the
    reference's per-frame ETA prints)."""

    def __init__(self, total: int):
        self.total = total
        self.done = 0
        self.start = time.time()

    def step(self) -> str:
        self.done += 1
        avg = (time.time() - self.start) / self.done
        eta = avg * (self.total - self.done)
        return f"[{self.done}/{self.total}] avg {avg:.1f}s/item, ETA {eta/60:.1f} min"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the host ops and, where there is a card,
    its kernels, written to ``log_dir`` as a TensorBoard trace."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
