"""Frames/s sweep and device-time breakdown of the PyTorch port on one card.

Run from the repository root on a machine with an NVIDIA H100::

    python3 scripts/torch_slice_profile.py [--speed exact balanced fast] [--post-ops]

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

With ``--post-ops`` it also splits the cost of the runner's two post-ops:
one exact ``large`` runner at batch 2 streams 96 frames made of one base
frame plus integer noise in [-3, 3] (a static scene, so the smoother blends)
with neither option, ``temporal_smooth=0.8`` alone, ``fetch_pack="u16"``
alone, both, and neither again, frames/s of each on the host clock after a
warm-up stream.

With ``--pipeline N`` it runs the frames -> depth -> floor-plan pipeline
(``video/pipeline.py::process_images_to_floor_plans``, as
``depth-pro-video-torch`` calls it) over N PNG frames of 1080x1920 from seed 0
on one exact ``large`` runner at batch 2 with 4 geometry workers: a first run
with the host geometry fits and caches ``ground.json`` (and builds the host
geometry's C++ library). Then, for each geometry that ``--geometry host
device`` names (default host): the host chain with the fast renderer (shape
fitting where scikit-learn imports), or the device floor-plan program (after
one run that derives and caches its framing), two runs read frames/s, when
the first and last frame's geometry started and the geometry seconds per
frame with the ground cached, first with the runner's own choice of decode
pool (processes on 4 or more cores), then with threads; for the device
geometry the program's own ms per frame follows (CUDA events on one frame's
depth); a last run under the profiler gives the device's idle share and time
by kernel group over the same window as above. Without ``--speed`` it then
skips the tiers.

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
    ("K3 biased attention", r"attention_(bf16|fp32|wgmma)_kernel<\d+, true[,>]"),
    ("K1 attention", r"attention_(bf16|fp32|wgmma)_kernel"),
    ("K2 resblock", r"resblock_(wgmma_)?kernel"),
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


def post_ops(where: str) -> None:
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16",
                              batch_size=PROFILE_BATCH, rng_seed=0, device="cuda")
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    pool = [np.clip(base.astype(np.int16) + rng.integers(-3, 4, base.shape), 0, 255)
            .astype(np.uint8) for _ in range(8)]
    window = [pool[i % len(pool)] for i in range(SWEEP_FRAMES)]
    # both options are read per stream, so one runner (one set of weights) serves every case
    for smooth, fetch in ((0.0, "none"), (0.8, "none"), (0.0, "u16"), (0.8, "u16"),
                          (0.0, "none")):
        runner.temporal_smooth, runner.fetch_pack = smooth, fetch
        stream_fps(runner, window[:4 * PROFILE_BATCH])
        fps = stream_fps(runner, window)
        print(f"[post-ops] exact, batch {PROFILE_BATCH}, temporal_smooth {smooth}, fetch_pack "
              f"{fetch}: {fps} frames/s over {SWEEP_FRAMES} frames on {where}", flush=True)


def pipeline_kwargs(geometry: str, fit_shapes: bool) -> dict:
    """``process_images_to_floor_plans``'s options for one geometry: the host
    chain with the fast renderer (shape fitting where scikit-learn imports,
    without its extra files), or the device program (plain floor plans only,
    so no shape fitting)."""
    if geometry == "device":
        return {"geometry": "device", "fit_shapes": False}
    return {"geometry": "host", "renderer": "fast", "fit_shapes": fit_shapes,
            "output_all_files": False}


def event_ms(fn, iters: int = 10) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events), after a warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def pipeline_profile(n_frames: int, where: str, geometries: list) -> None:
    import importlib.util

    from PIL import Image

    from ml_depth_pro_video_tpu_torch.geom.device_floorplan import DeviceFloorplanSession
    from ml_depth_pro_video_tpu_torch.video import pipeline

    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16",
                              batch_size=PROFILE_BATCH, rng_seed=0, device="cuda")
    fit_shapes = importlib.util.find_spec("sklearn") is not None
    own_pool = runner.decode_pool
    starts: list = []   # each frame's geometry start, seconds after its run began
    geometry: list = []
    seen: dict = {}     # the device session and one frame's inputs to its program
    real_frame, real_process = pipeline.process_single_frame, DeviceFloorplanSession.process

    def timed_frame(*args, **kwargs):
        starts.append(time.perf_counter() - run_start[0])
        ok, dt = real_frame(*args, **kwargs)
        geometry.append(dt)
        return ok, dt

    def recording_process(self, depth, image, f_px, output_path):
        seen.update(session=self, args=(depth, image, f_px))
        return real_process(self, depth, image, f_px, output_path)

    run_start = [0.0]
    with tempfile.TemporaryDirectory() as tmp:
        frames = Path(tmp) / "frames"
        frames.mkdir()
        rng = np.random.default_rng(0)
        for i in range(n_frames):
            Image.fromarray(rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)).save(
                frames / f"output_{i:06d}.png")

        def run(out: str, geo: str) -> float:
            starts.clear()
            geometry.clear()
            torch.cuda.synchronize()
            run_start[0] = time.perf_counter()
            done = pipeline.process_images_to_floor_plans(
                str(frames), output_dir=str(Path(tmp) / out), batch_size=PROFILE_BATCH,
                num_workers=4, runner=runner, **pipeline_kwargs(geo, fit_shapes))
            torch.cuda.synchronize()
            if len(done) != n_frames:
                raise RuntimeError(f"pipeline: {len(done)} of {n_frames} frames succeeded")
            return time.perf_counter() - run_start[0]

        first_s = run("first", "host")  # fits and caches ground.json
        print(f"[pipeline] exact, batch {PROFILE_BATCH}, 4 geometry workers, fast renderer, "
              f"shape fitting {'on' if fit_shapes else 'off'}, {n_frames} frames of 1080x1920: "
              f"first run (ground fit) {first_s:.3f} s on {where}", flush=True)
        pipeline.process_single_frame = timed_frame
        DeviceFloorplanSession.process = recording_process
        try:
            for geo in geometries:
                if geo == "device":  # derives and caches the framing: floorplan_limits.json
                    print(f"[pipeline] geometry device: first run (framing) "
                          f"{run('framing', geo):.3f} s", flush=True)
                # the runner's decode pool is read per stream: its own choice, then threads
                for pool in (own_pool, "thread"):
                    runner.decode_pool = pool
                    wall = run(f"timed_{geo}_{pool}", geo)
                    times = sorted(geometry)
                    print(f"[pipeline] geometry {geo}, ground cached, {pool} decode pool: "
                          f"{n_frames / wall} frames/s ({wall:.3f} s); first geometry start "
                          f"{min(starts):.3f} s, last {max(starts):.3f} s; geometry median "
                          f"{times[len(times) // 2]:.4f} s per frame (min {times[0]:.4f}, max "
                          f"{times[-1]:.4f}) on {where}", flush=True)
                if geo == "device":
                    session = seen["session"]
                    args = [torch.as_tensor(a).cuda() for a in seen["args"]]
                    ms = event_ms(lambda: session._fn(*args))
                    print(f"[pipeline] device floor-plan program: {ms:.3f} ms per frame (CUDA "
                          f"events, median of 10 calls on one frame's depth, subsample "
                          f"{session.subsample}, raster {session.cfg.raster_height}x"
                          f"{session.cfg.raster_width}) on {where}", flush=True)
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    prof_wall = run(f"profiled_{geo}", geo)
                trace = Path(tmp) / f"trace_{geo}.json"
                prof.export_chrome_trace(str(trace))
                rep = breakdown(trace, -(-n_frames // PROFILE_BATCH))
                print(f"[pipeline] geometry {geo} under the profiler (thread decode pool): "
                      f"{n_frames / prof_wall} frames/s; window without the first and last "
                      f"batch: {rep['window_ms']:.3f} ms; device busy {rep['busy_ms']:.3f} ms; "
                      f"idle share {rep['idle_share']:.4f}")
                for label, us in rep["by_group"]:
                    print(f"[pipeline group] {geo}: {us / 1e3:10.3f} ms "
                          f"{us / 1e3 / rep['summed_ms']:7.2%}  {label}")
        finally:
            pipeline.process_single_frame = real_frame
            DeviceFloorplanSession.process = real_process


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--speed", nargs="+", choices=sorted(SPEED_PRESETS), default=None,
                    help="speed tiers to sweep and profile (default: exact, or none with "
                         "--pipeline)")
    ap.add_argument("--post-ops", action="store_true",
                    help="also time the temporal smoother and the packed fetch")
    ap.add_argument("--pipeline", type=int, default=0, metavar="FRAMES",
                    help="also time and profile the floor-plan pipeline over FRAMES frames")
    ap.add_argument("--geometry", nargs="+", choices=["host", "device"], default=["host"],
                    help="the pipeline's geometry: the host chain, the device floor-plan "
                         "program, or both in turn (default: host)")
    args = ap.parse_args(argv)
    if args.speed is None:
        args.speed = [] if args.pipeline else ["exact"]
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    where = card()
    print(f"card: {where}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for speed in args.speed:
        profile_speed(speed, where)
    if args.post_ops:
        post_ops(where)
    if args.pipeline:
        pipeline_profile(args.pipeline, where, args.geometry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
