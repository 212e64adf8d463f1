"""Frames/s sweep and device-time breakdown of the PyTorch port on one card.

Run from the repository root on a machine with an NVIDIA H100::

    python3 scripts/torch_slice_profile.py [--speed exact balanced fast]

For each speed tier asked for (default: exact) it builds one
``large``-preset ``DepthVideoRunner`` (ViT-L, 1536^2, random weights from
seed 0, bf16) and feeds it 1080x1920 uint8 frames held in memory (decode is
not timed):

1. for batch sizes 1, 2, 4 and 8, frames/s over a window of 96 frames after
   a warm-up stream, on the host clock, ending in ``torch.cuda.synchronize()``;
2. at batch 2 (chip_smoke's), a ``torch.profiler`` trace of a stream of 32
   frames after a warm-up stream. From the trace's device
   events (kernels, copies, memsets) it reports, inside a window that leaves
   out the first and the last batch of the stream (one batch being the
   stream's device span divided by its number of batches), the device's idle
   share and the device time by kernel group and by kernel name.

Every line carries the card's name and power limit as nvidia-smi prints them.
The profiler's own host cost makes the idle share an upper bound for the
unprofiled run; the script prints both rates so they can be compared.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ml_depth_pro_video_tpu_torch.models.depth_pro import (  # noqa: E402
    SPEED_PRESETS,
    model_preset,
)
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner  # noqa: E402

SWEEP_BATCHES = (1, 2, 4, 8)
SWEEP_FRAMES = 96
PROFILE_BATCH = 2
PROFILE_FRAMES = 32
TOP_KERNELS = 25
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# first match wins: cuDNN conv kernels contain "gemm" too, so convs come first
GROUPS = [
    ("K3 biased attention (csrc/attention_packed.cu)",
     r"attention_(bf16|fp32)_kernel<\d+, true[,>]"),
    ("K1 attention (csrc/attention_packed.cu)", r"attention_(bf16|fp32)_kernel"),
    ("K2 resblock (csrc/resblock.cu)", r"resblock_kernel"),
    ("conv (cuDNN)", r"conv|fprop|dgrad|wgrad|cudnn"),
    ("GEMM (cuBLAS)", r"nvjet|gemm|cutlass|xmma"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("GELU", r"gelu|GeluCUDA"),
    ("copy / cast", r"copy|Copy|Memcpy|memcpy|Memset|memset|cat_|CatArray"),
    ("sort / scatter / gather (ToMe merge and others)", r"[Ss]ort|scatter|gather|index"),
    ("reduce", r"reduce|Reduce"),
    ("other elementwise", r"elementwise|vectorized|unrolled"),
]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def group_of(name: str) -> str:
    for label, pattern in GROUPS:
        if re.search(pattern, name):
            return label
    return "other"


def busy_in(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def stream_fps(runner: DepthVideoRunner, frames: list) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in runner.depth_stream(frames))
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def breakdown(trace_path: Path, n_batches: int) -> dict:
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events]
    first, last = min(s for s, _ in spans), max(e for _, e in spans)
    per_batch = (last - first) / n_batches
    lo, hi = first + per_batch, last - per_batch
    by_name: dict[str, float] = defaultdict(float)
    for e, (s, t) in zip(events, spans):
        clipped = min(t, hi) - max(s, lo)
        if clipped > 0:
            by_name[e["name"]] += clipped
    by_group: dict[str, float] = defaultdict(float)
    for name, us in by_name.items():
        by_group[group_of(name)] += us
    busy = busy_in(spans, lo, hi)
    return {"window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (hi - lo), "summed_ms": sum(by_name.values()) / 1e3,
            "by_group": sorted(by_group.items(), key=lambda kv: -kv[1]),
            "by_name": sorted(by_name.items(), key=lambda kv: -kv[1])}


def profile_speed(speed: str, where: str) -> None:
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16", batch_size=1,
                              rng_seed=0, speed=speed, device="cuda")
    rng = np.random.default_rng(0)
    pool = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(8)]

    def frames(n: int) -> list:
        return [pool[i % len(pool)] for i in range(n)]

    for b in SWEEP_BATCHES:
        runner.batch_size = b
        stream_fps(runner, frames(4 * b))  # warm-up stream at this batch size
        torch.cuda.reset_peak_memory_stats()
        fps = stream_fps(runner, frames(SWEEP_FRAMES))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[sweep] speed {speed}, batch {b}: {fps} frames/s over {SWEEP_FRAMES} frames, "
              f"peak allocated {peak:.2f} GiB on {where}", flush=True)

    b = runner.batch_size = PROFILE_BATCH
    n_batches = -(-PROFILE_FRAMES // b)
    stream_fps(runner, frames(4 * b))
    plain_fps = stream_fps(runner, frames(PROFILE_FRAMES))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            prof_fps = stream_fps(runner, frames(PROFILE_FRAMES))
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        rep = breakdown(trace, n_batches)
    print(f"[profile] speed {speed}, batch {b}, {PROFILE_FRAMES} frames ({n_batches} batches): "
          f"{plain_fps} frames/s unprofiled, {prof_fps} frames/s under the profiler, on {where}")
    print(f"[profile] window without the first and last batch: {rep['window_ms']:.3f} ms; "
          f"device busy {rep['busy_ms']:.3f} ms; idle share {rep['idle_share']:.4f}; "
          f"summed device time {rep['summed_ms']:.3f} ms "
          f"({rep['summed_ms'] / (n_batches - 2) / b:.3f} ms per frame)")
    for label, us in rep["by_group"]:
        print(f"[group] {us / 1e3:10.3f} ms {us / 1e3 / rep['summed_ms']:7.2%}  {label}")
    for name, us in rep["by_name"][:TOP_KERNELS]:
        print(f"[kernel] {us / 1e3:10.3f} ms {us / 1e3 / rep['summed_ms']:7.2%}  "
              f"{group_of(name)}: {name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--speed", nargs="+", choices=sorted(SPEED_PRESETS), default=["exact"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    where = card()
    print(f"card: {where}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for speed in args.speed:
        profile_speed(speed, where)
    return 0


if __name__ == "__main__":
    sys.exit(main())
