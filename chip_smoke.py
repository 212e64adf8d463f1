"""On-card smoke test of the PyTorch/CUDA port (``ml_depth_pro_video_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: torch/CUDA versions, card name and power limit (nvidia-smi);
2. build: the CUDA kernels are compiled from ``csrc/*.cu`` (seconds timed);
3. kernels: K1 (packed attention) and K2 (fused resblock) against their
   plain PyTorch versions on the card at the slice's shapes and at ragged
   ones, with the error bound stated, and both timed with CUDA events;
4. slice: a ``DepthVideoRunner`` at the ``large`` preset (ViT-L, 1536^2,
   random weights, bf16, batch 2) runs 1080x1920 uint8 frames through
   ``depth_stream``; outputs are checked and the kernels' launch counts
   must match 72 K1 and 3 K2 launches per forward; then frames/s over a
   96-frame window after a warm-up stream;
5. accuracy: bf16 against fp32 (TF32 off) canonical inverse depth on one
   frame at full size, and the tiny config on the card against the CPU
   path (plain versions) on a small non-square frame.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``{"kernels": [...]}`` with each kernel's launches, error and times.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ml_depth_pro_video_tpu_torch.ckpt.params import init_depth_pro, map_tree
from ml_depth_pro_video_tpu_torch.core.precision import Precision, disable_tf32
from ml_depth_pro_video_tpu_torch.kernels.loader import load_library
from ml_depth_pro_video_tpu_torch.models.depth_pro import (
    forward,
    infer_fn,
    model_preset,
    tiny_config,
)
from ml_depth_pro_video_tpu_torch.ops.attention import (
    K1,
    attention_packed,
    attention_packed_reference,
)
from ml_depth_pro_video_tpu_torch.ops.resblock import (
    K2,
    fused_residual_block,
    residual_block_reference,
)
from ml_depth_pro_video_tpu_torch.ops.resize import resize2d
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner

SEED = 0
BATCH = 2  # the slice's batch size: K1 sees (35*BATCH, 577, 3072) and (BATCH, 577, 3072)
# slice shapes at batch 1 and at BATCH, then ragged ones; (2, 65, 192) with 2 heads is hd=32
K1_SHAPES = [((35 * BATCH, 577, 3072), 16), ((BATCH, 577, 3072), 16), ((35, 577, 3072), 16),
             ((1, 577, 3072), 16), ((3, 33, 192), 4), ((2, 65, 384), 2), ((2, 65, 192), 2)]
K1_BOUNDS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
K2_SHAPES = [(BATCH, 48, 48, 256), (BATCH, 96, 96, 256), (1, 48, 48, 256), (1, 20, 24, 64)]
TIMED_FRAMES = 96  # the fps window: ~6 s at the large preset, after a warm-up stream
K2_BOUND = 2e-2  # bf16 tap-accumulation band of the JAX package's own test
K1_PER_FORWARD = 72  # 24 blocks x (patch ViT + image ViT + FOV ViT)
K2_PER_FORWARD = 3   # decoder resblocks at 48^2 (1) and 96^2 (2)
# JAX package's bf16-vs-fp32 envelope on TPU v5e (docs/PERFORMANCE.md:402), share of scale
TPU_ENVELOPE = {"median": 3.6e-4, "p99": 4.6e-3, "max": 1.09e-2}
BF16_MAX_DEV = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20) -> float:
    """Median wall time of one call on the card, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|), in fp32."""
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"capability {torch.cuda.get_device_capability(0)}")
    log(card())  # the card's name and power limit, as nvidia-smi prints them
    disable_tf32()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    load_library()
    log(f"[build] kernels built from csrc/*.cu and loaded in {time.perf_counter() - t0:.1f} s")


def phase_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(SEED)
    report = {}
    for shape, heads in K1_SHAPES:
        base = torch.randn(shape, generator=g, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            qkv = base.to(dtype)
            got = attention_packed(qkv, heads)
            ref = attention_packed_reference(qkv, heads)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            ok = rel <= K1_BOUNDS[dtype]
            line = (f"[kernels] K1 attention_packed {dtype} {shape} heads={heads}: "
                    f"max_abs_err={err:.3e} rel={rel:.3e} (bound {K1_BOUNDS[dtype]:g})")
            if shape[1] == 577:
                ms = median_ms(lambda: attention_packed(qkv, heads))
                plain = median_ms(lambda: attention_packed_reference(qkv, heads))
                line += f" kernel {ms:.3f} ms plain {plain:.3f} ms"
                if dtype == torch.bfloat16 and shape[0] == 35 * BATCH:
                    report["K1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                    "shape": "x".join(map(str, shape)), "dtype": "bf16",
                                    "rel_err": rel}
            log(line)
            if not ok:
                raise AssertionError(f"K1 {dtype} {shape}: rel error {rel:.3e} above bound")
    for shape in K2_SHAPES:
        c = shape[-1]
        x = (torch.randn(shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
        w1, w2 = (torch.randn((3, 3, c, c), generator=g, device="cuda") * (9 * c) ** -0.5
                  for _ in range(2))
        b1, b2 = (torch.randn((c,), generator=g, device="cuda") * 0.1 for _ in range(2))
        got = fused_residual_block(x, w1, b1, w2, b2)
        ref = residual_block_reference(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        line = (f"[kernels] K2 resblock bf16 {shape}: max_abs_err={err:.3e} rel={rel:.3e} "
                f"(bound {K2_BOUND:g})")
        if c == 256:
            ms = median_ms(lambda: fused_residual_block(x, w1, b1, w2, b2))
            plain = median_ms(lambda: residual_block_reference(x, w1, b1, w2, b2))
            line += f" kernel {ms:.3f} ms plain {plain:.3f} ms"
            if shape[:2] == (BATCH, 96):
                report["K2"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                "shape": "x".join(map(str, shape)), "dtype": "bf16",
                                "rel_err": rel}
        log(line)
        if not rel < K2_BOUND:
            raise AssertionError(f"K2 {shape}: rel error {rel:.3e} above bound")
    return report


def phase_slice(n_frames: int = 4, batch_size: int = BATCH) -> tuple[DepthVideoRunner, dict]:
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16",
                              batch_size=batch_size, rng_seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(n_frames)]
    K1.launches = K2.launches = 0
    results = list(runner.depth_stream(frames))
    torch.cuda.synchronize()
    launches = {"K1": K1.launches, "K2": K2.launches}
    forwards = math.ceil(n_frames / batch_size)
    log(f"[slice] large preset, bf16, batch {batch_size}: {len(results)} frames, "
        f"{forwards} forwards, launches K1={launches['K1']} K2={launches['K2']}")
    if len(results) != n_frames:
        raise AssertionError(f"{len(results)} results for {n_frames} frames")
    for r in results:
        d, f = r["depth"], r["focallength_px"]
        if d.shape != (1080, 1920) or not np.isfinite(d).all() or not (d > 0).all():
            raise AssertionError(f"bad depth: shape {d.shape}, finite {np.isfinite(d).all()}")
        if not math.isfinite(f):
            raise AssertionError(f"non-finite f_px {f}")
    log(f"[slice] depth (1080, 1920) finite and positive, range "
        f"[{min(r['depth'].min() for r in results):.4g}, "
        f"{max(r['depth'].max() for r in results):.4g}] m; f_px "
        f"{[round(r['focallength_px'], 2) for r in results]}")
    if launches != {"K1": K1_PER_FORWARD * forwards, "K2": K2_PER_FORWARD * forwards}:
        raise AssertionError(f"kernel launches {launches} != {K1_PER_FORWARD}/{K2_PER_FORWARD} "
                             f"per forward x {forwards}")

    # fps over a window of many batches, after a warm-up stream (the stream
    # above warmed up the same runner); 8 distinct frames, cycled
    pool = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(8)]
    timed = [pool[i % len(pool)] for i in range(TIMED_FRAMES)]
    sum(1 for _ in runner.depth_stream(timed[:4 * batch_size]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in runner.depth_stream(timed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[slice] {n / wall} frames/s over {n} frames of 1080x1920 in {wall:.3f} s "
        f"(batch {batch_size}, bf16, frames in memory, after a warm-up stream) on {card()}")
    return runner, launches


def phase_accuracy(runner: DepthVideoRunner) -> None:
    cfg, params = runner.cfg, runner.params
    rng = np.random.default_rng(SEED + 1)
    frame = torch.from_numpy(rng.integers(0, 256, (1, 1080, 1920, 3), dtype=np.uint8)).cuda()
    x = resize2d(frame.float() / 127.5 - 1.0, (cfg.img_size, cfg.img_size))
    with torch.inference_mode():
        c32, _ = forward(params, x, cfg, Precision.fp32(), compute_fov=False)
        c16, _ = forward(params, x, cfg, Precision.bf16(), compute_fov=False)
    c32, c16 = c32.float(), c16.float()
    if not (torch.isfinite(c32).all() and torch.isfinite(c16).all()):
        raise AssertionError("non-finite canonical inverse depth")
    dev = ((c16 - c32).abs() / c32.abs().max().clamp_min(1e-30)).flatten()
    med, p99, mx = (torch.quantile(dev[::4], 0.5).item(), torch.quantile(dev[::4], 0.99).item(),
                    dev.max().item())
    log(f"[accuracy] bf16 vs fp32 canonical inverse depth (share of scale): median {med:.3e} "
        f"p99 {p99:.3e} max {mx:.3e}; JAX TPU v5e envelope median {TPU_ENVELOPE['median']:.1e} "
        f"p99 {TPU_ENVELOPE['p99']:.1e} max {TPU_ENVELOPE['max']:.2e}; fail above {BF16_MAX_DEV}")
    if mx > BF16_MAX_DEV:
        raise AssertionError(f"bf16 deviation {mx:.3e} above {BF16_MAX_DEV}")

    tiny = tiny_config()
    cpu_params = init_depth_pro(tiny, torch.Generator().manual_seed(SEED), "cpu")
    gpu_params = map_tree(lambda t: t.cuda(), cpu_params)
    img = torch.from_numpy(rng.standard_normal((1, 300, 410, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = infer_fn(cpu_params, img, None, tiny, Precision.fp32())
        got = infer_fn(gpu_params, img.cuda(), None, tiny, Precision.fp32())
    torch.testing.assert_close(got["depth"].cpu(), ref["depth"], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got["focallength_px"].cpu(), ref["focallength_px"], rtol=1e-3,
                               atol=1e-4)
    log("[accuracy] tiny config fp32, card (K1) vs CPU plain path: depth and f_px within "
        "rtol 1e-3 / atol 1e-4")


def main() -> int:
    device = phase_device()
    phase_build()
    report = phase_kernels()
    runner, launches = phase_slice()
    phase_accuracy(runner)
    kernels = []
    for key, k in (("K1", K1), ("K2", K2)):
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": launches[key],
                        **report[key]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
