"""On-card smoke test of the PyTorch/CUDA port (``ml_depth_pro_video_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: torch/CUDA versions, card name and power limit (nvidia-smi);
2. build: the CUDA kernels are compiled from ``csrc/*.cu``, one nvcc per
   source, all started together (seconds timed);
3. kernels: K1 (packed attention), K2 (fused resblock), K3 (packed attention
   with a per-key bias, -inf keys included) and K4 (attention on (B, H, S, D))
   against their plain PyTorch versions on the card at the shapes the paths
   give them and at ragged ones, with the error bound stated; each timed
   with CUDA events beside its plain version, beside one PyTorch call that
   computes the same function where there is one (``library_ms``:
   ``scaled_dot_product_attention`` on the same views, a yardstick the port
   never calls) and beside its bound (the larger of its bytes over 3.35 TB/s
   and its operations over the card's peak for their type); the attention
   kernels' entries carry the fp32 (parity mode) reading at the same shape
   under ``fp32``, K1's the bf16 one at the image ViT's (2, 577, 3072)
   under ``small_shape``, and K2's (2, 96, 96, 256) entry its (2, 48, 48,
   256) reading there; K2 is also timed beside the plain composition at the
   192^2 and 384^2 levels that the width gate keeps on the plain path, each
   K2 line names the tiling the kernel took, and K2's entries carry the
   profiler's device time of K2 and of the plain composition (whose many
   launches leave the card waiting on the host) under ``device_ms`` and
   ``plain_device_ms``; times are medians over runs of back-to-back calls;
4. slice: a ``DepthVideoRunner`` at the ``large`` preset (ViT-L, 1536^2,
   random weights, bf16, batch 2) runs 1080x1920 uint8 frames through
   ``depth_stream``; outputs are checked and the kernels' launch counts
   must match 72 K1 and 3 K2 launches per forward (no K3); then frames/s
   over a 96-frame window after a warm-up stream;
4b. speed slices: the same at ``speed="balanced"`` and ``speed="fast"`` (ToMe
   token merging), where each forward must launch 50 K1, 22 K3 and 3 K2;
4c. the unpacked-attention entry point ``multi_head_attention`` at a ViT-L
   block's shape must launch K4 once;
5. accuracy: bf16 against fp32 (TF32 off) canonical inverse depth on one
   frame at full size, and the tiny config on the card against the CPU
   path (plain versions) on a small non-square frame;
5b. speed-tier accuracy: the checked-in ToMe proxy weights
   (``tests/fixtures/tome_proxy_weights.npz``) at merge ratios 0.25 and 0.5,
   fp32 on the card (K1, K3) against the CPU path.

Before each path's run every launch count is set to 0 and it is read just
after; launches made to compare a kernel with its plain version do not
count. The last line is ``{"ok": true, "device": {...}}``; the line before
it is ``{"kernels": [...]}`` with each kernel's launches, error and times.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ml_depth_pro_video_tpu_torch.ckpt.params import (
    from_numpy_tree,
    init_depth_pro,
    load_params,
    map_tree,
)
from ml_depth_pro_video_tpu_torch.core.precision import Precision, disable_tf32
from ml_depth_pro_video_tpu_torch.kernels.loader import load_library
from ml_depth_pro_video_tpu_torch.models import vit as vit_module
from ml_depth_pro_video_tpu_torch.models.depth_pro import (
    DepthProConfig,
    forward,
    infer_fn,
    model_preset,
    tiny_config,
)
from ml_depth_pro_video_tpu_torch.models.vit import ViTConfig
from ml_depth_pro_video_tpu_torch.ops.attention import (
    K1,
    K3,
    K4,
    _split_packed,
    attention_packed,
    attention_packed_reference,
    attention_reference,
    multi_head_attention,
)
from ml_depth_pro_video_tpu_torch.ops.resblock import (
    FUSED_MAX_WIDTH,
    K2,
    fused_residual_block,
    k2_tile,
    residual_block_reference,
)
from ml_depth_pro_video_tpu_torch.ops.resize import resize2d
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner

SEED = 0
BATCH = 2  # the slice's batch size: K1 sees (35*BATCH, 577, 3072) and (BATCH, 577, 3072)
KERNELS = {"K1": K1, "K2": K2, "K3": K3, "K4": K4}
# slice shapes at batch 1 and at BATCH, then ragged ones; (2, 65, 192) with 2 heads is hd=32
K1_SHAPES = [((35 * BATCH, 577, 3072), 16), ((BATCH, 577, 3072), 16), ((35, 577, 3072), 16),
             ((1, 577, 3072), 16), ((3, 33, 192), 4), ((2, 65, 384), 2), ((2, 65, 192), 2)]
# the speed tiers' patch-ViT shapes (balanced keeps 433 of 577 tokens, fast 289) at BATCH
# and at batch 1, then ragged ones
K3_SHAPES = [((35 * BATCH, 433, 3072), 16), ((35 * BATCH, 289, 3072), 16),
             ((35, 433, 3072), 16), ((35, 289, 3072), 16), ((3, 33, 192), 4), ((2, 65, 192), 2)]
# a ViT-L block's attention in (B, H, S, D) at batch 2 and 1, then ragged ones
K4_SHAPES = [(35 * BATCH, 16, 577, 64), (35, 16, 577, 64), (3, 4, 33, 32), (2, 2, 65, 16)]
ATTN_BOUNDS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # share of scale, TF32 off
# the decoder's K2 levels at BATCH and batch 1, then ragged ones, then the levels the width gate
# keeps on the plain composition (timed beside it)
K2_SHAPES = [(BATCH, 48, 48, 256), (BATCH, 96, 96, 256), (1, 48, 48, 256), (1, 20, 24, 64),
             (BATCH, 9, 7, 24), (BATCH, 192, 192, 256), (BATCH, 384, 384, 256)]
TIMED_FRAMES = 96  # the fps window: ~6 s at the large preset, after a warm-up stream
K2_BOUND = 2e-2  # bf16 tap-accumulation band of the JAX package's own test
PER_FORWARD = {  # kernel launches per forward of the large preset
    "exact": {"K1": 72, "K2": 3, "K3": 0, "K4": 0},  # 24 blocks x 3 ViTs; 3 decoder resblocks
    # patch ViT blocks 0-1 exact, the merge, blocks 2-23 with the size bias; image and FOV
    # ViTs exact
    "balanced": {"K1": 50, "K2": 3, "K3": 22, "K4": 0},
    "fast": {"K1": 50, "K2": 3, "K3": 22, "K4": 0},
}
# JAX package's bf16-vs-fp32 envelope on TPU v5e (docs/PERFORMANCE.md:402), share of scale
TPU_ENVELOPE = {"median": 3.6e-4, "p99": 4.6e-3, "max": 1.09e-2}
BF16_MAX_DEV = 0.05
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
PROXY = Path(__file__).resolve().parent / "tests" / "fixtures" / "tome_proxy_weights.npz"
PROXY_RATIOS = (0.25, 0.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, short_ms: float = 0.2, short_iters: int = 100,
              calls: int = 5) -> float:
    """Median time of one call on the card, from CUDA events around runs of
    ``calls`` back-to-back calls (so the host's time to issue a call hides
    behind the one before, as it does on the model's path): of ``iters``
    runs, or of ``short_iters`` where those read under ``short_ms`` (a
    ~50 us kernel is noisy under a median of 20)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def once() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    times = [once() for _ in range(iters)]
    if statistics.median(times) < short_ms:
        times = [once() for _ in range(short_iters)]
    return statistics.median(times)


def device_ms(fn, calls: int = 10) -> float:
    """Device time of one call: its kernels' own time summed by the profiler
    over ``calls`` calls, without the gaps where the card waits on the host."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / calls / 1e3


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|), in fp32."""
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, dtype: torch.dtype) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the bytes
    the function must move (inputs read once, outputs written once) over the
    memory rate, or its operations over the peak rate for their type."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def attention_flops(b: int, h: int, s: int, hd: int) -> float:
    return 4.0 * b * h * s * s * hd  # Q.K^T and P.V


def sdpa_on(q, k, v, key_bias=None):
    """The one PyTorch call that computes the same attention (yardstick only):
    the bias goes in as a float mask in the query's dtype."""
    mask = None if key_bias is None else key_bias[:, None, None, :].to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def timed(kernel, plain, library, flops: float, moved: int, dtype) -> tuple[dict, str]:
    """Time a kernel beside its plain version and its library call (None:
    there is none), and reckon its bound. Returns (times, a log suffix)."""
    t = {"ms": median_ms(kernel), "plain_ms": median_ms(plain),
         "library_ms": None if library is None else median_ms(library)}
    t["bound_ms"], t["bound_by"] = bound(flops, moved, dtype)
    lib = "" if library is None else f" library {t['library_ms']:.3f} ms"
    return t, (f" kernel {t['ms']:.3f} ms plain {t['plain_ms']:.3f} ms{lib} "
               f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")


def report_entry(err, rel, times, shape, dtype) -> dict:
    return {"max_abs_err": err, "rel_err": rel, **times, "shape": "x".join(map(str, shape)),
            "dtype": {torch.bfloat16: "bf16", torch.float32: "fp32"}[dtype]}


def add_to_report(report: dict, err, rel, times, shape, dtype) -> None:
    """An attention kernel's entry at its batch-2 shape: the bf16 reading at
    the top level, the fp32 (parity mode) one at the same shape under ``fp32``."""
    entry = report_entry(err, rel, times, shape, dtype)
    if dtype == torch.bfloat16:
        report.update(entry)
    else:
        report["fp32"] = entry


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


def _check(name: str, rel: float, limit: float, line: str) -> None:
    log(line)
    if not rel <= limit:
        raise AssertionError(f"{name}: rel error {rel:.3e} above bound {limit:g}")


def kernels_k1(g) -> dict:
    report = {}
    for shape, heads in K1_SHAPES:
        base = torch.randn(shape, generator=g, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            qkv = base.to(dtype)
            got = attention_packed(qkv, heads)
            ref = attention_packed_reference(qkv, heads)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            line = (f"[kernels] K1 attention_packed {dtype} {shape} heads={heads}: "
                    f"max_abs_err={err:.3e} rel={rel:.3e} (bound {ATTN_BOUNDS[dtype]:g})")
            if shape[1] == 577:
                b, s, d3 = shape
                times, suffix = timed(lambda: attention_packed(qkv, heads),
                                      lambda: attention_packed_reference(qkv, heads),
                                      sdpa_on(*_split_packed(qkv, heads)),
                                      attention_flops(b, heads, s, d3 // 3 // heads),
                                      nbytes(qkv, got), dtype)
                line += suffix
                if shape[0] == 35 * BATCH:
                    add_to_report(report, err, rel, times, shape, dtype)
                elif dtype == torch.bfloat16 and shape[0] == BATCH:
                    # the image and FOV ViTs' shape: 48 launches per forward
                    report["small_shape"] = report_entry(err, rel, times, shape, dtype)
            _check(f"K1 {dtype} {shape}", rel, ATTN_BOUNDS[dtype], line)
    # K4 is K1's kernel body read through other strides: the same bits
    qkv = torch.randn((35 * BATCH, 577, 3072), generator=g, device="cuda").bfloat16()
    q, k, v = (t.contiguous() for t in _split_packed(qkv, 16))
    same = torch.equal(attention_packed(qkv, 16),
                       multi_head_attention(q, k, v).transpose(1, 2).reshape(qkv.shape[0], 577,
                                                                             1024))
    log(f"[kernels] K4 on the unpacked q, k, v equals K1 on the packed qkv bit for bit: {same}")
    if not same:
        raise AssertionError("K4 and K1 disagree on the same data")
    return report


def kernels_k3(g) -> dict:
    report = {}
    for shape, heads in K3_SHAPES:
        base = torch.randn(shape, generator=g, device="cuda")
        # ToMe's bias: the log of integer token counts >= 1
        bias = torch.randint(1, 5, shape[:2], generator=g, device="cuda").float().log()
        for dtype in (torch.bfloat16, torch.float32):
            qkv = base.to(dtype)
            got = attention_packed(qkv, heads, bias)
            ref = attention_packed_reference(qkv, heads, bias)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            line = (f"[kernels] K3 attention_packed_bias {dtype} {shape} heads={heads}: "
                    f"max_abs_err={err:.3e} rel={rel:.3e} (bound {ATTN_BOUNDS[dtype]:g})")
            if shape[-1] == 3072:
                b, s, d3 = shape
                times, suffix = timed(lambda: attention_packed(qkv, heads, bias),
                                      lambda: attention_packed_reference(qkv, heads, bias),
                                      sdpa_on(*_split_packed(qkv, heads), bias),
                                      attention_flops(b, heads, s, d3 // 3 // heads),
                                      nbytes(qkv, bias, got), dtype)
                line += suffix
                if shape[:2] == (35 * BATCH, 433):
                    add_to_report(report, err, rel, times, shape, dtype)
            _check(f"K3 {dtype} {shape}", rel, ATTN_BOUNDS[dtype], line)
    # -inf keys: a whole first key tile, scattered keys, and every key of one item
    b, s, heads = 3, 150, 2
    bias = torch.randint(1, 5, (b, s), generator=g, device="cuda").float().log()
    bias[0, :64] = -math.inf
    bias[1, ::3] = -math.inf
    bias[2] = -math.inf
    base = torch.randn((b, s, 3 * heads * 64), generator=g, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        qkv = base.to(dtype)
        got = attention_packed(qkv, heads, bias)
        ref = attention_packed_reference(qkv, heads, bias)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and (got[2] == 0).all()):
            raise AssertionError(f"K3 {dtype}: NaN or a non-zero row under an all -inf bias")
        err, rel = rel_err(got[:2], ref[:2])
        _check(f"K3 {dtype} -inf keys", rel, ATTN_BOUNDS[dtype],
               f"[kernels] K3 {dtype} -inf bias on a whole key tile and on scattered keys: "
               f"max_abs_err={err:.3e} rel={rel:.3e}; on every key of an item: finite zeros")
    return report


def kernels_k4(g) -> dict:
    report = {}
    for shape in K4_SHAPES:
        bases = [torch.randn(shape, generator=g, device="cuda") for _ in range(3)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in bases)
            got = multi_head_attention(q, k, v)
            ref = attention_reference(q, k, v)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            line = (f"[kernels] K4 attention_bhsd {dtype} {shape}: max_abs_err={err:.3e} "
                    f"rel={rel:.3e} (bound {ATTN_BOUNDS[dtype]:g})")
            if shape[2] == 577:
                times, suffix = timed(lambda: multi_head_attention(q, k, v),
                                      lambda: attention_reference(q, k, v), sdpa_on(q, k, v),
                                      attention_flops(*shape), nbytes(q, k, v, got), dtype)
                line += suffix
                if shape[0] == 35 * BATCH:
                    add_to_report(report, err, rel, times, shape, dtype)
            _check(f"K4 {dtype} {shape}", rel, ATTN_BOUNDS[dtype], line)
    return report


def resblock_flops(b: int, h: int, w: int, c: int) -> float:
    return 2 * 2.0 * b * h * w * 9 * c * c  # two 3x3 convolutions, C -> C


def kernels_k2(g) -> dict:
    report = {}
    for shape in K2_SHAPES:
        b, h, w, c = shape
        x = (torch.randn(shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
        w1, w2 = (torch.randn((3, 3, c, c), generator=g, device="cuda") * (9 * c) ** -0.5
                  for _ in range(2))
        b1, b2 = (torch.randn((c,), generator=g, device="cuda") * 0.1 for _ in range(2))
        got = fused_residual_block(x, w1, b1, w2, b2)
        ref = residual_block_reference(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        th, tw = k2_tile(b, h, w)
        line = (f"[kernels] K2 resblock bf16 {shape} ({th}x{tw} tiles): max_abs_err={err:.3e} "
                f"rel={rel:.3e} (bound {K2_BOUND:g})")
        if c == 256:
            # two 3x3 convolutions; no single PyTorch call computes the whole block
            kernel = lambda: fused_residual_block(x, w1, b1, w2, b2)  # noqa: E731
            plain = lambda: residual_block_reference(x, w1, b1, w2, b2)  # noqa: E731
            times, suffix = timed(kernel, plain, None, resblock_flops(*shape),
                                  nbytes(x, w1, b1, w2, b2, got), torch.bfloat16)
            # the plain composition's launches wait on the host: its device time apart
            times["device_ms"], times["plain_device_ms"] = device_ms(kernel), device_ms(plain)
            line += (f"{suffix}; device {times['device_ms']:.3f} ms, plain "
                     f"{times['plain_device_ms']:.3f} ms")
            if w > FUSED_MAX_WIDTH:  # the width gate's evidence: K2 against the plain path
                line += (f"; width gate {FUSED_MAX_WIDTH}: K2 takes "
                         f"{times['ms'] / times['plain_ms']:.3f}x the plain time, "
                         f"{times['device_ms'] / times['plain_device_ms']:.3f}x its device time")
            if shape == (BATCH, 96, 96, 256):
                report.update(report_entry(err, rel, times, shape, torch.bfloat16))
            elif shape == (BATCH, 48, 48, 256):
                report["small_shape"] = report_entry(err, rel, times, shape, torch.bfloat16)
        log(line)
        if not rel < K2_BOUND:
            raise AssertionError(f"K2 {shape}: rel error {rel:.3e} above bound")
    return report


def phase_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(SEED)
    return {"K1": kernels_k1(g), "K2": kernels_k2(g), "K3": kernels_k3(g), "K4": kernels_k4(g)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def check_results(results, n_frames: int, tag: str) -> None:
    if len(results) != n_frames:
        raise AssertionError(f"{tag}: {len(results)} results for {n_frames} frames")
    for r in results:
        d, f = r["depth"], r["focallength_px"]
        if d.shape != (1080, 1920) or not np.isfinite(d).all() or not (d > 0).all():
            raise AssertionError(f"{tag}: bad depth: shape {d.shape}, finite "
                                 f"{np.isfinite(d).all()}")
        if not math.isfinite(f):
            raise AssertionError(f"{tag}: non-finite f_px {f}")
    log(f"[{tag}] depth (1080, 1920) finite and positive, range "
        f"[{min(r['depth'].min() for r in results):.4g}, "
        f"{max(r['depth'].max() for r in results):.4g}] m; f_px "
        f"{[round(r['focallength_px'], 2) for r in results]}")


def run_slice(speed: str, n_frames: int = 4, batch_size: int = BATCH, timed: int = TIMED_FRAMES):
    """One path: a large-preset runner at ``speed`` streams ``n_frames``
    frames with the launch counts set to 0 before and read after; then
    frames/s over ``timed`` frames after a warm-up stream. Returns
    (runner, launches)."""
    tag = "slice" if speed == "exact" else f"slice {speed}"
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16",
                              batch_size=batch_size, rng_seed=SEED, speed=speed, device="cuda")
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(n_frames)]
    torch.cuda.synchronize()
    reset_launches()
    results = list(runner.depth_stream(frames))
    torch.cuda.synchronize()
    launches = read_launches()
    forwards = math.ceil(n_frames / batch_size)
    log(f"[{tag}] large preset, bf16, batch {batch_size}, speed {speed}: {len(results)} frames, "
        f"{forwards} forwards, launches {launches}")
    check_results(results, n_frames, tag)
    want = {name: n * forwards for name, n in PER_FORWARD[speed].items()}
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != {want} "
                             f"({PER_FORWARD[speed]} per forward x {forwards})")

    # fps over a window of many batches, after a warm-up stream (the stream
    # above warmed up the same runner); 8 distinct frames, cycled
    pool = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(8)]
    window = [pool[i % len(pool)] for i in range(timed)]
    sum(1 for _ in runner.depth_stream(window[:4 * batch_size]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in runner.depth_stream(window))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[{tag}] {n / wall} frames/s over {n} frames of 1080x1920 in {wall:.3f} s "
        f"(batch {batch_size}, bf16, speed {speed}, frames in memory, after a warm-up stream) "
        f"on {card()}")
    return runner, launches


def phase_unpacked_entry() -> dict:
    """The unpacked-attention entry point at a ViT-L block's shape."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v = (torch.randn(K4_SHAPES[0], generator=g, device="cuda").bfloat16()
               for _ in range(3))
    torch.cuda.synchronize()
    reset_launches()
    out = multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[unpacked] multi_head_attention {tuple(q.shape)} bf16: launches {launches}")
    if launches != {"K1": 0, "K2": 0, "K3": 0, "K4": 1} or not torch.isfinite(out).all():
        raise AssertionError(f"multi_head_attention: launches {launches}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    return launches


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


def tome_proxy_config() -> DepthProConfig:
    """The architecture of the speed tiers' quality-gate proxy (``PROXY``,
    twin of the JAX package's ``utils/synthetic.py::tome_proxy_config``):
    8-block ViT, 128 wide, at 512 px, hooks after blocks 1 and 3, the merge
    after block 2, no FOV head."""
    return DepthProConfig(
        vit=ViTConfig(img_size=128, patch_size=16, embed_dim=128, depth=8, num_heads=4,
                      mlp_ratio=4),
        decoder_features=32,
        dims_encoder=(32, 64, 128, 128),
        hook_block_ids=(1, 3),
        use_fov_head=False,
        checkpoint_uri=None,
    )


def phase_speed_accuracy() -> None:
    """The ToMe proxy weights, fp32: card (K1, K3) against the CPU path."""
    tree = load_params(str(PROXY))
    cpu_params = from_numpy_tree(tree, "cpu")
    gpu_params = from_numpy_tree(tree, "cuda")
    rng = np.random.default_rng(SEED + 3)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 384, 512, 3)).astype(np.float32))
    f_px = torch.tensor([400.0, 520.0])
    real_merge = vit_module.compute_token_merge
    for ratio in PROXY_RATIOS:
        cfg = dataclasses.replace(tome_proxy_config(), token_merge_ratio=ratio)
        maps = []

        def recording(tokens, r):
            out = real_merge(tokens, r)
            maps.append(None if out is None else out[1].cpu())
            return out

        vit_module.compute_token_merge = recording
        try:
            with torch.inference_mode():
                ref = infer_fn(cpu_params, img, f_px, cfg, Precision.fp32())
                reset_launches()
                got = infer_fn(gpu_params, img.cuda(), f_px.cuda(), cfg, Precision.fp32())
                torch.cuda.synchronize()
                launches = read_launches()
        finally:
            vit_module.compute_token_merge = real_merge
        same_maps = len(maps) == 2 and maps[0] is not None and torch.equal(maps[0], maps[1])
        dev = (got["depth"].cpu() - ref["depth"]).abs().max().item()
        log(f"[speed accuracy] ToMe proxy weights, ratio {ratio}, fp32, card (launches "
            f"{launches}) vs CPU plain path: max |depth diff| {dev:.3e} m; merge maps "
            f"identical: {same_maps}")
        if launches["K3"] == 0:
            raise AssertionError("the proxy's merged blocks did not launch K3")
        torch.testing.assert_close(got["depth"].cpu(), ref["depth"], rtol=1e-3, atol=1e-4)
    log("[speed accuracy] depth within rtol 1e-3 / atol 1e-4 at ratios "
        f"{', '.join(map(str, PROXY_RATIOS))}")


def main() -> int:
    device = phase_device()
    phase_build()
    report = phase_kernels()
    runner, exact = run_slice("exact")
    phase_accuracy(runner)
    del runner
    paths = {"exact": exact}
    for speed in ("balanced", "fast"):
        runner, paths[speed] = run_slice(speed)
        del runner
    paths["multi_head_attention"] = phase_unpacked_entry()
    phase_speed_accuracy()
    kernels = []
    for key, k in KERNELS.items():
        by_path = {name: counts[key] for name, counts in paths.items()}
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **report[key]})
    log(f"[done] {card()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
