"""Tracing / profiling utilities.

``span`` marks a stretch of host work in a ``torch.profiler`` trace, as a
``user_annotation`` range on the profiler's own clock, beside the card's
kernels, copies and memsets. ``device_trace`` is how an operator captures
such a trace outside the benchmark: host ops, kernels and the spans (for
instance the phases of ``video/runner.py::DepthVideoRunner.depth_stream``)
on one timeline, written for TensorBoard's profiler plugin or Perfetto.
``ETAReporter`` is the JAX package's (``ml_depth_pro_video_tpu/utils/
profiling.py``).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str, seq: int | None = None):
    """A ``record_function`` range called ``name`` (``name#seq`` with a
    sequence number, e.g. a batch's, which trace readers split off) while a
    ``torch.profiler`` runs; otherwise a context that does nothing, for the
    cost of reading one flag. No flag or variable turns it on: a running
    profiler is the switch."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name if seq is None else f"{name}#{seq}")


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
    """``torch.profiler`` trace of the host ops, the ``span`` ranges opened
    inside it and, where there is a card, its kernels, written to
    ``log_dir`` as a TensorBoard trace (``*.pt.trace.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
