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
4a. maps: the runner with ``temporal_smooth=0.8`` and ``fetch_pack="u16"``
   (large, bf16, batch 2) streams 8 frames of 1080x1920 (one base frame plus
   integer noise in [-3, 3], so most pixels are static and the smoother
   blends them) with 72 K1 and 3 K2 launches per forward; the result is held
   against the exact slice's runner (both options off) on the same frames
   followed by the host twin of the smoother, frame by frame: within
   ``max_rel_error() + 1e-5`` on at least 99.99% of pixels. Then the times
   of the pack and the smoother per batch of 2 (CUDA events and the
   profiler's device time), the device-to-host copy of the fp32 depth and of
   the u16 codes, the host unpack per frame, and frames/s over 96 frames with
   both options beside the exact slice's (``scripts/torch_slice_profile.py
   --post-ops`` splits that cost between the two options);
4b. speed slices: the same at ``speed="balanced"`` and ``speed="fast"`` (ToMe
   token merging), where each forward must launch 50 K1, 22 K3 and 3 K2;
4c. the unpacked-attention entry point ``multi_head_attention`` at a ViT-L
   block's shape must launch K4 once;
5. accuracy: bf16 against fp32 (TF32 off) canonical inverse depth on one
   frame at full size, and the tiny config on the card against the CPU
   path (plain versions) on a small non-square frame;
5b. speed-tier accuracy: the checked-in ToMe proxy weights
   (``tests/fixtures/tome_proxy_weights.npz``) at merge ratios 0.25 and 0.5,
   fp32 on the card (K1, K3) against the CPU path;
6. pipeline: ``depth-pro-video-torch`` (``cli/pipeline.py::main``, in the
   main thread) over 8 PNG frames of 1080x1920 at the ``large`` preset
   (``--batch_size 2 --num_workers 4 --renderer fast``; ``--fit_shapes
   --output_main_only`` where scikit-learn imports, else ``--no_fit_shapes``),
   after the host geometry's C++ library (``native/*.cpp``) is built and
   loaded; every frame must be a success in ``processing_progress.json``,
   ``ground.json`` finite, every ``*_clean_simple_view.png`` decodable, and the
   launches 72 K1 and 3 K2 per forward, frame 0's ground-fit ``infer_one``
   counting as one (no K3 or K4); then the pipeline's frames/s, the median
   geometry seconds per frame, the ground fit's seconds and the exact slice's
   frames/s;
6a. device_floorplan: the floor-plan program of ``geom/device_floorplan.py``
   on a structured 1080x1920 scene (a floor, a back wall and box faces,
   ray-cast and blurred like monocular depth edges) with the ground plane
   fitted from it: the card against the same function on the CPU (``debug``
   outputs: coordinates, masks, raster), then against the port's host chain
   under ``tests/test_device_floorplan.py``'s gates (stray superset, shadow
   mismatch, raster disagreement and colour); the card's call runs under
   ``torch.cuda.set_sync_debug_mode("error")`` up to the raster's fetch; ms
   per frame at subsample 1 and 2 (CUDA events) and the peak memory;
6b. pipeline_device: ``depth-pro-video-torch --geometry device`` over the
   pipeline phase's 8 frames without ``ground.json``: 8 successes,
   ``floorplan_limits.json`` with its fingerprint, 8 plans of the raster's
   size, 72 K1 and 3 K2 per forward (no K3 or K4); then frames/s with the
   ground and the framing cached, beside the host geometry's in the same
   call;
6c. effect: ``parallax_frames`` at 1080x1920 for the three motions and
   ``anaglyph_image``, the card against the CPU path (uint8 |diff| <= 1 on at
   most ``EFFECT_SHARE`` of the values), ms per frame; then
   ``depth-pro-effect-torch`` on one PNG: an mp4 that ``cv2.VideoCapture``
   reads back with ``duration*fps`` frames, and the anaglyph PNG (72 K1 and 3
   K2 per image);
6d. tools: one ``large`` bf16 runner on the card drives the four CLIs that run
   the model through their functions with ``runner=`` on the structured
   scene's 1080x1920 PNG: ``depth-pro-pointcloud-torch`` (a PLY),
   ``depth-pro-clean-torch``, ``depth-pro-mesh-torch`` (Poisson at depth 8,
   256^3, with its HTML viewer) and ``depth-pro-floorplan-torch``, each one
   forward of 72 K1 and 3 K2; every file must exist and decode, the PLYs'
   points be finite, the OBJ have faces and each ``ground.json`` be finite
   (random-weight depth: the path, not the geometry). Then the mesh run's
   seconds split into forward, solve and host geometry; the screened Poisson
   CG at 256^3 on a cloud of the scene's true depth, the card against the CPU
   on one system (max |diff| within ``POISSON_BOUND`` of max |chi|,
   iterations within 1, equal marching-tetrahedra counts), its ms and ms per
   iteration beside its bound; then ``depth-pro-view-torch`` (html and a
   PNG view), ``depth-pro-ply-floorplan-torch`` where matplotlib imports (the
   line says which case held) and ``depth-pro-eval-torch`` (the runner's npz
   against the scene's true depth: finite metrics) through ``main``;
6e. serve: ``create_server`` (``serve/server.py``) at the ``large`` preset,
   bf16, ``max_batch=4``, ``max_wait_ms=30``, warm-up on, ``port=0``, driven
   from this process by ``urllib`` clients over one 1080x1920 PNG of the
   structured scene: 8 lone requests (concurrency 1, each padded to a batch
   of 4), 32 at concurrency 8, an ``npz`` and a ``png16`` request and a
   4-frame ``session`` stream (``smooth=0.8``) beside its unsmoothed
   responses. Every response must be 200 with depth of (1080, 1920), finite
   and positive; the npz's min and max equal the json's, the png16 decodes
   with its three headers; ``/metrics`` counts every request sent and as many
   batches as forwards, each forward launching 72 K1 and 3 K2 (the warm-up's
   forward counted apart); no process starts while serving; the session
   stream equals the host twin of the smoother over the unsmoothed
   responses; a lone request's depth agrees with ``runner.infer_one`` on the
   host-canonicalised frame, resized back the same way, within
   ``SERVE_REF_BOUND`` of scale. Then latency p50 / p95 at concurrency 1 and
   8, requests/s at 8, the batch fill ratio, the host's share per request
   (PNG decode, canonical resize, resize back, npz and png16 encodes) and the
   runner's per-batch pool set-up with threads (the server's) and with the
   spawn process pool;
6f. quantize: the runner with ``quantize=True`` (large, bf16, batch 2):
   ``torch.cuda.memory_allocated()`` after its build beside the serve
   runner's (fp32 master weights), the saving against
   ``quantized_saving``; 72 K1 and 3 K2 per forward; its canonical inverse
   depth on one frame against the unquantized runner's (median, p99, max of
   |diff| over the scale; fail above ``QUANT_MAX_DEV``, the JAX package's TPU
   figure printed beside it); frames/s beside the exact slice's; the tiny
   config's int8 codes on the card equal to the CPU's, and its quantized fp32
   forward on the card against the CPU within rtol 1e-3 / atol 1e-4;
7. maps CLI: ``depth-pro-maps-torch`` over 4 PNG frames of 1080x1920
   (``--save_npz --packed_fetch --colormap gray16 --batch_size 2``, 72 K1 and
   3 K2 launches per forward), then ``depth-pro-smooth-torch`` over its npz
   files; file counts, shapes and finiteness are checked (needs Pillow).

8. export: ``depth-pro-export-torch`` (``ckpt/export.py::main``) writes the
   ``torch.export`` artifact of the ``large`` preset (bf16, batch 2, random
   weights: the artifact holds none) for ``--speed exact`` and ``--speed
   balanced``; for each, a fresh ``DepthVideoRunner(exported_path=...)``
   streams 4 frames of 1536x1536 uint8 through ``depth_stream``: every
   forward must go through the artifact (``exported_calls``), launching 72 K1
   and 3 K2 (exact) or 50 K1, 22 K3 and 3 K2 (balanced), and depth and f_px
   must equal an eager runner's with the same params on the same frames bit
   for bit. Printed beside the card's name and power limit: export and load
   seconds, the artifact's bytes, the first-batch latency of a fresh runner
   (its build and its first batch of 2) with the artifact and without it,
   and frames/s of both over the same 32-frame window.

Before each path's run every launch count is set to 0 and it is read just
after; launches made to compare a kernel with its plain version do not
count. The last line is ``{"ok": true, "device": {...}}``; the line before
it is ``{"kernels": [...]}`` with each kernel's launches, error and times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ml_depth_pro_video_tpu_torch import native
from ml_depth_pro_video_tpu_torch.cli import (
    depth_to_floorplan,
    eval_depth,
    generate_depth_maps,
    img_to_pointcloud,
    pointcloud_cleaner,
    pointcloud_to_mesh,
    smooth_depth,
    view_pointcloud,
)
from ml_depth_pro_video_tpu_torch.cli import pipeline as cli_pipeline
from ml_depth_pro_video_tpu_torch.ckpt.export import load_exported
from ml_depth_pro_video_tpu_torch.ckpt.export import main as export_main
from ml_depth_pro_video_tpu_torch.ckpt.params import (
    from_numpy_tree,
    init_depth_pro,
    load_params,
    map_tree,
)
from ml_depth_pro_video_tpu_torch.ckpt.quantize import quantize_vit_weights
from ml_depth_pro_video_tpu_torch.core.precision import Precision, disable_tf32
from ml_depth_pro_video_tpu_torch.effects import parallax
from ml_depth_pro_video_tpu_torch.geom.clean import clean_shadows, remove_stray_points
from ml_depth_pro_video_tpu_torch.geom.device_floorplan import (
    DeviceFloorplanConfig,
    make_device_floorplan,
)
from ml_depth_pro_video_tpu_torch.geom import floorplan, mesh
from ml_depth_pro_video_tpu_torch.geom.floorplan_viz import fast_floorplan_image
from ml_depth_pro_video_tpu_torch.geom.ground import grid_ground_adjustment, normalize_to_ground
from ml_depth_pro_video_tpu_torch.geom.pointcloud import PointCloud, read_ply
from ml_depth_pro_video_tpu_torch.geom.unproject import depth_to_3d
from ml_depth_pro_video_tpu_torch.kernels.loader import load_library
from ml_depth_pro_video_tpu_torch.models import vit as vit_module
from ml_depth_pro_video_tpu_torch.models.depth_pro import (
    DepthProConfig,
    apply_speed,
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
from ml_depth_pro_video_tpu_torch.serve.server import (
    canonicalize,
    create_server,
    encode_npz,
    encode_png16,
    restore,
)
from ml_depth_pro_video_tpu_torch.video import pipeline
from ml_depth_pro_video_tpu_torch.video.pack import max_rel_error, pack_depth_u16, unpack_depth_u16
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from ml_depth_pro_video_tpu_torch.video.temporal import (
    TemporalSmoother,
    _update_core_np,
    smooth_batch,
)

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
MAPS_FRAMES = 8  # the maps phase's stream: 4 forwards at BATCH
SMOOTH_ALPHA = 0.8
MAPS_SLACK = 1e-5  # fp32 log/exp and the device's reduction order, beside the packing bound
MAPS_SHARE = 0.9999  # of pixels within the bound; the rest are static-gate flips at tau
MAPS_CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_maps"  # ignored by git
PIPELINE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_pipeline"  # ignored by git
PIPELINE_FRAMES = 8  # 5 forwards at BATCH: frame 0 alone, then 7 frames in 4 batches
PROXY = Path(__file__).resolve().parent / "tests" / "fixtures" / "tome_proxy_weights.npz"
EFFECT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_effect"  # ignored by git
SCENE_F_PX = 1500.0  # the structured scene's focal length at 1920 px wide
# the card against the CPU path of the same floor-plan program: fp32 ops in the same order on
# both sides, so only ulp-level differences (a 3-element norm's order, the libraries' division
# and sqrt) reach the outputs
FP_COORD_ATOL = 1e-4  # metres, max |diff| of x / y / z over valid points
FP_MASK_SHARE = 1e-3  # of points whose valid / keep_stray / keep differ
FP_RASTER_SHARE = 1e-3  # of raster pixels that differ
# tests/test_device_floorplan.py's gates against the host chain, copied as they are
STRAY_EXTRA, SHADOW_MISMATCH, BG_MISSING, BG_DIFFER, COLOR_P95 = 0.35, 0.02, 0.02, 0.15, 0.02
EFFECT_SHARE = 1e-3  # of uint8 values that may differ by 1 (sin / cos differ by ulps); none by more
EFFECT_FRAMES = (1.0, 8)  # the effect's (duration s, fps): 8 frames
PROXY_RATIOS = (0.25, 0.5)
SERVE_BATCH, SERVE_WAIT_MS = 4, 30.0  # the server's max_batch and max_wait_ms (its defaults)
SERVE_LONE = 8  # sequential lone requests: the latency at concurrency 1
SERVE_CONCURRENCY, SERVE_REQUESTS = 8, 32  # requests at concurrency 8
SERVE_SESSION = 4  # frames of the session stream
# a lone request against infer_one on the same canonical frame, share of scale: the same
# batch of 4 copies through the same kernels, so only the fetch and the resizes could differ
SERVE_REF_BOUND = 1e-4
# the session stream against the host twin over the unsmoothed responses (relative): the
# same numpy filter on the same depth
SERVE_SMOOTH_BOUND = 1e-6
QUANT_MAX_DEV = 0.05  # int8 against bf16 canonical inverse depth, share of scale (random weights)
# the JAX package's chip figure (ckpt/quantize.py docstring): the quantization adds a median
# 0.0002% of scale on top of the bf16 mode's own deviation; printed beside ours, not enforced
TPU_QUANT_MEDIAN = 2e-6
QUANT_SAVING_SLACK = 0.01  # a build's bytes beyond its parameters (the allocator's rounding), of the saving
TOOLS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tools"  # ignored by git
# random-weight depth puts most points at the 1e4 m clamp, ~0.1 m apart: the cleaning settings
# of the JAX package's CLI test on random weights (tests/test_cli_drivers.py) keep the cloud
RANDOM_DEPTH_CLEAN = dict(nb_points=3, radius=1.0, max_shadow_angle=0.0)
# depth-pro-floorplan's raster has a cell per 5 cm of the plan's extent, which random-weight depth
# makes hundreds of kilometres (96 GiB of host memory ran out): cells no smaller than the extent
# over this
FLOORPLAN_CELLS = 2048
POISSON_DEPTH = 8  # depth-pro-mesh's default: a 256^3 grid
POISSON_SCREEN, POISSON_VOXEL = 4.0, 0.05  # create_mesh_from_pointcloud's defaults
# the card's chi against the CPU's, share of max |chi|: fp32 in the same op order on both, the dot
# products summed in float64 (tests/test_torch_mesh.py holds the CPU's against JAX's under it)
POISSON_BOUND = 1e-4
EXPORT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_export"  # ignored by git
EXPORT_FRAMES = 4  # two forwards at BATCH per runner, compared bit for bit
EXPORT_TIMED = 32  # the frames/s window of the artifact and of the eager runner


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


def kernel_times(fn, calls: int = 10) -> list:
    """(kernel name, device ms per call) of one call's kernels, the most time
    first: the profiler's own kernel time over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / calls / 1e3) for e in prof.key_averages()]
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, calls: int = 10) -> float:
    """Device time of one call: its kernels' own time summed by the profiler
    over ``calls`` calls, without the gaps where the card waits on the host."""
    return sum(ms for _, ms in kernel_times(fn, calls))


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


def frames_per_s(runner: DepthVideoRunner, window: list, batch_size: int) -> float:
    """Frames/s of ``runner.depth_stream`` over ``window``, after a warm-up stream."""
    sum(1 for _ in runner.depth_stream(window[:4 * batch_size]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in runner.depth_stream(window))
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def run_slice(speed: str, n_frames: int = 4, batch_size: int = BATCH, timed: int = TIMED_FRAMES):
    """One path: a large-preset runner at ``speed`` streams ``n_frames``
    frames with the launch counts set to 0 before and read after; then
    frames/s over ``timed`` frames after a warm-up stream. Returns
    (runner, launches, frames/s)."""
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

    # fps over a window of many batches, after a warm-up stream; 8 distinct frames, cycled
    pool = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(8)]
    fps = frames_per_s(runner, [pool[i % len(pool)] for i in range(timed)], batch_size)
    log(f"[{tag}] {fps} frames/s over {timed} frames of 1080x1920 (batch {batch_size}, bf16, "
        f"speed {speed}, frames in memory, after a warm-up stream) on {card()}")
    return runner, launches, fps


def noisy_frames(n: int, rng: np.random.Generator) -> list:
    """One base 1080x1920 frame plus integer noise in [-3, 3] per frame: a
    static scene, so the smoother has pixels to blend."""
    base = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    return [np.clip(base.astype(np.int16) + rng.integers(-3, 4, base.shape), 0, 255)
            .astype(np.uint8) for _ in range(n)]


def outside_bound(got: np.ndarray, want: np.ndarray, bound: float) -> tuple[float, float]:
    """(share of pixels whose relative error to ``want`` exceeds ``bound``,
    the largest relative error)."""
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    return float(np.mean(rel > bound)), float(rel.max())


def smoothed_reference(depths: list) -> tuple[list, float]:
    """The host twin of the smoother over ``depths`` in order, the first frame
    seeding the state; and the share of pixels the static gate blended (where
    the output at alpha 0.8 differs from the aligned frame, alpha 0)."""
    state, out, blended = depths[0], [depths[0]], []
    for d in depths[1:]:
        new, _ = _update_core_np(state, d, alpha=SMOOTH_ALPHA, tau=0.05, align=True)
        aligned, _ = _update_core_np(state, d, alpha=0.0, tau=0.05, align=True)
        blended.append(np.mean(new != aligned))
        state = new
        out.append(new)
    return out, float(np.mean(blended))


def phase_maps(plain: DepthVideoRunner, exact_fps: float) -> dict:
    """The runner with temporal smoothing and the packed fetch on: launches,
    agreement with the exact runner's depth smoothed on the host, the post-ops'
    times and frames/s."""
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16", batch_size=BATCH,
                              rng_seed=SEED, temporal_smooth=SMOOTH_ALPHA, fetch_pack="u16",
                              device="cuda")
    frames = noisy_frames(MAPS_FRAMES, np.random.default_rng(SEED + 4))
    torch.cuda.synchronize()
    reset_launches()
    results = list(runner.depth_stream(frames))
    torch.cuda.synchronize()
    launches = read_launches()
    forwards = math.ceil(MAPS_FRAMES / BATCH)
    log(f"[maps] large preset, bf16, batch {BATCH}, temporal_smooth {SMOOTH_ALPHA}, fetch_pack "
        f"u16: {len(results)} frames, {forwards} forwards, launches {launches}")
    check_results(results, MAPS_FRAMES, "maps")
    want = {name: n * forwards for name, n in PER_FORWARD["exact"].items()}
    if launches != want:
        raise AssertionError(f"maps: kernel launches {launches} != {want}")

    ref, blended = smoothed_reference([r["depth"] for r in plain.depth_stream(frames)])
    bound = max_rel_error() + MAPS_SLACK
    share, worst = outside_bound(np.stack([r["depth"] for r in results]), np.stack(ref), bound)
    log(f"[maps] smoothed u16 depth against the exact runner's depth smoothed by the host twin: "
        f"{share:.3e} of pixels above {bound:.4e} relative error (fail above "
        f"{1 - MAPS_SHARE:.0e}), largest {worst:.3e}; the static gate blended {blended:.4f} of "
        f"the pixels of frames 2-{MAPS_FRAMES}")
    if share > 1 - MAPS_SHARE:
        raise AssertionError(f"maps: {share:.3e} of pixels outside {bound:.4e}")

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    depth = 1.0 + 9.0 * torch.rand((BATCH, 1080, 1920), generator=g, device="cuda")
    state = depth[0] * 1.01
    pack = lambda: pack_depth_u16(depth)  # noqa: E731
    smooth = lambda: smooth_batch(state, depth, BATCH, alpha=SMOOTH_ALPHA)  # noqa: E731
    pack_ms, smooth_ms = median_ms(pack), median_ms(smooth)
    # back-to-back calls of these small ops wait on the host's launches: device time apart
    pack_dev, smooth_dev = device_ms(pack), device_ms(smooth)
    # the runner's fetch: a pinned copy of the fp32 depth, or of the u16 codes and two (B,) vectors
    packed = pack_depth_u16(depth)
    fp32_host = torch.empty(depth.shape, dtype=depth.dtype, pin_memory=True)
    u16_host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in packed]
    fetch_fp32_ms = median_ms(lambda: fp32_host.copy_(depth, non_blocking=True))
    fetch_u16_ms = median_ms(lambda: [h.copy_(t, non_blocking=True)
                                      for h, t in zip(u16_host, packed)])
    u, lmin, lscale = (h.numpy() for h in u16_host)
    unpack = []
    for _ in range(10):
        t0 = time.perf_counter()
        unpack_depth_u16(u[:1], lmin[:1], lscale[:1])
        unpack.append((time.perf_counter() - t0) * 1e3)
    # the pack reads the fp32 depth once and writes the u16 codes and two (B,) vectors
    pack_bound = (nbytes(depth) + nbytes(*packed)) / PEAK_BYTES * 1e3
    log(f"[maps] per batch of {BATCH} at 1080x1920 (CUDA events over back-to-back calls / the "
        f"profiler's device time): pack_depth_u16 {pack_ms:.4f} / {pack_dev:.4f} ms (bytes "
        f"bound {pack_bound:.4f} ms), smooth_batch {smooth_ms:.4f} / {smooth_dev:.4f} ms; "
        f"device-to-host copy into pinned memory (CUDA events): fp32 depth {fetch_fp32_ms:.4f} ms "
        f"({nbytes(depth) / fetch_fp32_ms / 1e6:.2f} GB/s), u16 codes and two vectors "
        f"{fetch_u16_ms:.4f} ms; host unpack {statistics.median(unpack):.3f} ms per frame "
        f"(median of 10) on {card()}")
    window = [frames[i % len(frames)] for i in range(TIMED_FRAMES)]
    fps = frames_per_s(runner, window, BATCH)
    log(f"[maps] {fps} frames/s over {TIMED_FRAMES} frames (batch {BATCH}, bf16) with both "
        f"options, beside the exact slice's {exact_fps}; on {card()}")
    return launches


def phase_maps_cli() -> dict:
    """``depth-pro-maps-torch`` over a directory of 4 PNG frames, then
    ``depth-pro-smooth-torch`` over the npz files it wrote."""
    from PIL import Image

    shutil.rmtree(MAPS_CLI_DIR, ignore_errors=True)
    frames, maps, smoothed = (MAPS_CLI_DIR / name for name in ("frames", "maps", "smoothed"))
    frames.mkdir(parents=True)
    for i, frame in enumerate(noisy_frames(4, np.random.default_rng(SEED + 6))):
        Image.fromarray(frame).save(frames / f"frame_{i:03d}.png")
    torch.cuda.synchronize()
    reset_launches()
    generate_depth_maps.main([str(frames), "-o", str(maps), "--save_npz", "--packed_fetch",
                              "--colormap", "gray16", "--batch_size", str(BATCH),
                              "--device", "cuda"])
    torch.cuda.synchronize()
    launches = read_launches()
    smooth_depth.main([str(maps), "--pattern", "*_depth.npz", "-o", str(smoothed),
                       "--device", "cuda"])
    pngs, npzs = sorted(maps.glob("*_depth.png")), sorted(maps.glob("*_depth.npz"))
    outs = sorted(smoothed.glob("*_depth.npz"))
    want = {name: n * 2 for name, n in PER_FORWARD["exact"].items()}
    if launches != want or not len(pngs) == len(npzs) == len(outs) == 4:
        raise AssertionError(f"maps CLI: launches {launches} (want {want}), {len(pngs)} PNGs, "
                             f"{len(npzs)} npz, {len(outs)} smoothed")
    for png, npz, out in zip(pngs, npzs, outs):
        img = np.asarray(Image.open(png))
        depth, smooth = np.load(npz)["depth"], np.load(out)["depth"]
        if img.shape != (1080, 1920) or img.dtype != np.uint16 or any(
                d.shape != (1080, 1920) or not np.isfinite(d).all() for d in (depth, smooth)):
            raise AssertionError(f"maps CLI: {png.name} {img.shape} {img.dtype}, depth "
                                 f"{depth.shape}, smoothed {smooth.shape}, finite "
                                 f"{np.isfinite(depth).all()} / {np.isfinite(smooth).all()}")
    log(f"[maps cli] depth-pro-maps-torch wrote 4 gray16 PNGs (1080x1920 uint16) and 4 npz "
        f"(launches {launches}); depth-pro-smooth-torch wrote 4 smoothed npz, all finite")
    shutil.rmtree(MAPS_CLI_DIR)
    return launches


def pipeline_forwards(n_frames: int, batch_size: int = BATCH) -> int:
    """Forwards of a pipeline run without a cached ``ground.json``: frame 0's
    ground-fit ``infer_one`` (one frame, padded to a batch), then the other
    frames in batches (frame 0's inference is reused, not run again)."""
    return 1 + math.ceil((n_frames - 1) / batch_size)


def shape_flags() -> tuple[list, str]:
    """Shape fitting where scikit-learn (DBSCAN) imports, without its
    matplotlib artifacts; else none."""
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return ["--no_fit_shapes"], "shape fitting off (scikit-learn does not import)"
    return ["--fit_shapes", "--output_main_only"], "shape fitting on (scikit-learn imports)"


def phase_pipeline(exact_fps: float) -> dict:
    """``depth-pro-video-torch`` over a directory of PNG frames: the frames ->
    depth -> floor-plan path with the host geometry on its native C++ route."""
    from PIL import Image

    t0 = time.perf_counter()
    if not native.neighbors.available():
        raise AssertionError("pipeline: the native geometry library did not build or load")
    log(f"[pipeline] native geometry library built from native/*.cpp and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    frames, plans = PIPELINE_DIR / "frames", PIPELINE_DIR / "plans"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 7)
    for i in range(PIPELINE_FRAMES):
        Image.fromarray(rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)).save(
            frames / f"output_{i:06d}.png")
    flags, shapes = shape_flags()
    # the geometry seconds of each frame and the ground fit's, read through the
    # module's own functions, which the pipeline looks up when it calls them
    geometry, ground = [], []
    real_frame, real_ground = pipeline.process_single_frame, pipeline.compute_ground_from_frame

    def timed_frame(*args, **kwargs):
        ok, dt = real_frame(*args, **kwargs)
        geometry.append(dt)
        return ok, dt

    def timed_ground(*args, **kwargs):
        t = time.perf_counter()
        model = real_ground(*args, **kwargs)
        ground.append(time.perf_counter() - t)
        return model

    pipeline.process_single_frame, pipeline.compute_ground_from_frame = timed_frame, timed_ground
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        cli_pipeline.main(["--frames_dir", str(frames), "--output_dir", str(plans),
                           "--batch_size", str(BATCH), "--num_workers", "4",
                           "--renderer", "fast", *flags, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        pipeline.process_single_frame, pipeline.compute_ground_from_frame = real_frame, real_ground
    forwards = pipeline_forwards(PIPELINE_FRAMES)
    log(f"[pipeline] depth-pro-video-torch, large preset, bf16, batch {BATCH}, 4 geometry "
        f"workers, fast renderer, {shapes}: {PIPELINE_FRAMES} frames of 1080x1920, {forwards} "
        f"forwards (frame 0 alone for the ground fit), launches {launches}")
    progress = json.loads((plans / "processing_progress.json").read_text())
    names = [f"output_{i:06d}.png" for i in range(PIPELINE_FRAMES)]
    failed = [n for n in names if not progress.get(n, {}).get("success")]
    if failed:
        raise AssertionError(f"pipeline: frames not recorded as successes: {failed}")
    model = json.loads((frames / "ground.json").read_text())
    values = [*model["normal"], model["d"], *model["origin"]]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"pipeline: ground.json not finite: {model}")
    for n in names:
        img = np.asarray(Image.open(plans / n.replace(".png", "_clean_simple_view.png")))
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise AssertionError(f"pipeline: {n}'s floor plan is {img.shape} {img.dtype}")
    want = {name: n * forwards for name, n in PER_FORWARD["exact"].items()}
    if launches != want:
        raise AssertionError(f"pipeline: kernel launches {launches} != {want} "
                             f"({PER_FORWARD['exact']} per forward x {forwards})")
    log(f"[pipeline] {PIPELINE_FRAMES} successes in processing_progress.json, ground.json "
        f"finite (normal {[round(v, 6) for v in model['normal']]}, d {model['d']:.6g}), "
        f"{PIPELINE_FRAMES} floor plans decode as RGB")
    log(f"[pipeline] {PIPELINE_FRAMES / wall} frames/s over the whole run ({wall:.3f} s: the "
        f"model's build, the decode pools, the ground fit, geometry and PNGs included); "
        f"geometry median {statistics.median(geometry):.4f} s per frame (min "
        f"{min(geometry):.4f}, max {max(geometry):.4f}); ground fit {ground[0]:.4f} s; the "
        f"exact slice's {exact_fps} frames/s in this run; on {card()}")
    # the frames stay for the pipeline_device phase, which removes the directory
    return launches, PIPELINE_FRAMES / wall


def structured_scene(h: int, w: int, f_px: float, seed: int) -> dict:
    """A room ray-cast through the pinhole camera of ``geom/unproject.py``
    (principal point at the centre, X and Y negated, depth = z): a floor, a
    back wall and three boxes (front and top faces) with Lambert-shaded
    albedo, the depth blurred by a Gaussian of sigma 1.5 px as monocular
    depth smears its edges (the shadow streaks the cleanup stages remove).
    Returns {"image": (h, w, 3) uint8, "depth": (h, w) float32, "f_px"}."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    # the point at depth t along pixel (xs, ys) is t * (dx, dy, 1)
    dx, dy = -(xs - w / 2.0) / f_px, -(ys - h / 2.0) / f_px
    t_hit = np.full((h, w), np.inf)
    normal, albedo = np.zeros((h, w, 3)), np.zeros((h, w, 3))

    def hit(t, cond, n, alb):
        ok = cond & (t > 0.1) & (t < t_hit)
        t_hit[ok], normal[ok], albedo[ok] = t[ok], n, alb

    floor_y, zb = -1.2 - rng.uniform(0.0, 0.3), rng.uniform(6.0, 8.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        hit(floor_y / dy, dy < 0, [0, 1, 0], rng.uniform(0.3, 0.9, 3))
        hit(np.full((h, w), zb), np.ones((h, w), bool), [0, 0, -1], rng.uniform(0.3, 0.9, 3))
        for _ in range(3):
            cx, cz = rng.uniform(-1.5, 1.5), rng.uniform(2.0, zb - 1.0)
            half, top = rng.uniform(0.2, 0.6), floor_y + rng.uniform(0.4, 1.2)
            alb = rng.uniform(0.2, 1.0, 3)
            hit(np.full((h, w), cz), (np.abs(dx * cz - cx) < half) & (dy * cz > floor_y)
                & (dy * cz < top), [0, 0, -1], alb)
            t = top / dy
            hit(t, (dy < 0) & (np.abs(dx * t - cx) < half) & (t > cz) & (t < cz + 2 * half),
                [0, 1, 0], alb)
    light = np.asarray([0.5, 0.8, -0.3]) / np.linalg.norm([0.5, 0.8, -0.3])
    lam = np.clip(normal @ light, 0.15, 1.0)[..., None]
    image = np.clip(albedo * lam * 255.0, 0, 255).astype(np.uint8)
    depth = gaussian_filter(t_hit, sigma=1.5).astype(np.float32)
    return {"image": image, "depth": depth, "f_px": f_px}


def host_keep(clean, points: np.ndarray) -> np.ndarray:
    """Which points the host filter ``clean`` keeps: each point carries its
    own index through the filter as its colour."""
    idx = np.arange(len(points), dtype=np.float64)
    out = clean(PointCloud(points, np.stack([idx] * 3, axis=-1)))
    keep = np.zeros(len(points), bool)
    keep[out.colors[:, 0].astype(np.int64)] = True
    return keep


def run_floorplan(fn, scene: dict, device: torch.device) -> dict:
    """One call of a floor-plan program; on the card the inputs are uploaded
    first and the call runs with every host sync an error, then the outputs
    are fetched."""
    args = (torch.from_numpy(scene["depth"]).to(device), torch.from_numpy(scene["image"]).to(device),
            torch.tensor(scene["f_px"], dtype=torch.float32, device=device))
    if device.type != "cuda":
        return {k: v.numpy() for k, v in fn(*args).items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_device_floorplan(scene: dict, ground: dict, device="cuda") -> tuple[dict, dict]:
    """The floor-plan program on ``device`` against the same function on the
    CPU and against the port's host chain, each under its stated bound.
    Returns (the readings, the program's config)."""
    dev = torch.device(device)
    h, w = scene["depth"].shape
    cloud = depth_to_3d(scene["depth"], scene["f_px"], image=scene["image"])
    host = PointCloud(grid_ground_adjustment(normalize_to_ground(cloud.points, ground)),
                      cloud.colors)
    above = host.points[:, 1] >= 0.1  # tests/test_device_floorplan.py's framing
    cfg = DeviceFloorplanConfig(
        height=h, width=w, x_limits=(float(-host.points[above, 0].max()),
                                     float(-host.points[above, 0].min())),
        z_limits=(float(host.points[above, 2].min()), float(host.points[above, 2].max())))
    got = run_floorplan(make_device_floorplan(cfg, ground, debug=True, device=dev), scene, dev)
    want = run_floorplan(make_device_floorplan(cfg, ground, debug=True, device="cpu"), scene,
                         torch.device("cpu"))
    valid = want["valid"]
    r = {"coord_err": max(float(np.abs(got[k][valid] - want[k][valid]).max()) for k in "xyz")}
    for k in ("valid", "keep_stray", "keep"):
        r[f"{k}_share"] = float(np.mean(got[k] != want[k]))
    r["raster_share"] = float(np.mean(np.any(got["raster"] != want["raster"], axis=-1)))
    log(f"[device_floorplan] {h}x{w} scene, {int(valid.sum())} valid points, raster "
        f"{cfg.raster_height}x{cfg.raster_width}: {device} against the CPU: coordinates max |diff| "
        f"{r['coord_err']:.3e} m (fail above {FP_COORD_ATOL:g}); differing valid / keep_stray / "
        f"keep {r['valid_share']:.3e} / {r['keep_stray_share']:.3e} / {r['keep_share']:.3e} of "
        f"points (fail above {FP_MASK_SHARE:g}); raster {r['raster_share']:.3e} of pixels (fail "
        f"above {FP_RASTER_SHARE:g})")
    if not (r["coord_err"] <= FP_COORD_ATOL and r["raster_share"] <= FP_RASTER_SHARE
            and max(r[f"{k}_share"] for k in ("valid", "keep_stray", "keep")) <= FP_MASK_SHARE):
        raise AssertionError(f"device_floorplan: {device} disagrees with the CPU: {r}")

    # tests/test_device_floorplan.py's gates, on the device's outputs against the host chain
    valid = got["valid"]
    dev_pts = np.stack([got[k][valid] for k in "xyz"], axis=-1)
    r["host_coord_err"] = float(np.abs(dev_pts - host.points).max()) if valid.sum() == len(
        host.points) else float("inf")
    keep_host = host_keep(remove_stray_points, host.points)
    keep_dev = got["keep_stray"][valid]
    r["stray_dropped"] = int((keep_host & ~keep_dev).sum())
    r["stray_extra"] = float((~keep_host & keep_dev).sum() / max(valid.sum(), 1))
    # the shadow filter alone: nb_points=1 keeps every point through the stray stage
    shadow = run_floorplan(make_device_floorplan(dataclasses.replace(cfg, stray_nb_points=1),
                                                 ground, debug=True, device=dev), scene, dev)
    r["shadow_mismatch"] = float(np.mean(host_keep(clean_shadows, host.points)
                                         != shadow["keep"][shadow["valid"]]))
    plan = fast_floorplan_image(clean_shadows(remove_stray_points(host)), None,
                                height_threshold=cfg.height_threshold, x_limits=cfg.x_limits,
                                z_limits=cfg.z_limits, width=cfg.raster_width)
    plan = plan.astype(np.float32) / 255.0
    bg_h = np.abs(plan - 0.94).max(-1) < 0.02
    bg_d = np.abs(got["raster"] - 0.94).max(-1) < 0.02
    r["bg_missing"] = float((~bg_h & bg_d).mean())
    r["bg_differ"] = float((bg_h != bg_d).mean())
    both = ~bg_h & ~bg_d
    r["color_p95"] = float(np.percentile(np.abs(plan - got["raster"]).max(-1)[both], 95))
    log(f"[device_floorplan] {device} against the host chain (tests/test_device_floorplan.py's "
        f"gates): valid points {int(valid.sum())} / host {len(host.points)}, coordinates max |diff| "
        f"{r['host_coord_err']:.3e} m (fp32 against float64, not gated); stray filter drops "
        f"{r['stray_dropped']} host-kept points (fail above 0), keeps {r['stray_extra']:.4f} extra "
        f"(fail above {STRAY_EXTRA}); shadow mismatch {r['shadow_mismatch']:.4f} (fail above "
        f"{SHADOW_MISMATCH}); raster: host-drawn pixels left background {r['bg_missing']:.4f} "
        f"(fail above {BG_MISSING}), background differs {r['bg_differ']:.4f} (fail above "
        f"{BG_DIFFER}), colour p95 {r['color_p95']:.4f} (fail above {COLOR_P95})")
    if not (valid.sum() == len(host.points) and r["stray_dropped"] == 0
            and r["stray_extra"] < STRAY_EXTRA and r["shadow_mismatch"] < SHADOW_MISMATCH
            and r["bg_missing"] < BG_MISSING and r["bg_differ"] < BG_DIFFER
            and r["color_p95"] < COLOR_P95):
        raise AssertionError(f"device_floorplan: a gate against the host chain failed: {r}")
    return r, cfg


def phase_device_floorplan(scene: dict) -> None:
    """The floor-plan program on the card: agreement (``check_device_floorplan``),
    then ms per frame at subsample 1 and 2 and the peak memory it adds."""
    ground = pipeline.compute_ground_from_frame(scene["depth"], scene["f_px"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, cfg = check_device_floorplan(scene, ground, "cuda")
    args = (torch.from_numpy(scene["depth"]).cuda(), torch.from_numpy(scene["image"]).cuda(),
            torch.tensor(scene["f_px"], dtype=torch.float32, device="cuda"))
    times, kernels = {}, {}
    for s in (1, 2):
        fn = make_device_floorplan(dataclasses.replace(cfg, subsample=s), ground, device="cuda")
        times[s] = median_ms(lambda: fn(*args), iters=10, calls=2)
        kernels[s] = kernel_times(lambda: fn(*args), calls=5)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    dev = {s: sum(ms for _, ms in rows) for s, rows in kernels.items()}
    log(f"[device_floorplan] {scene['depth'].shape[0]}x{scene['depth'].shape[1]} frame, raster "
        f"{cfg.raster_height}x{cfg.raster_width}: {times[1]:.3f} ms at subsample 1, {times[2]:.3f} "
        f"ms at subsample 2 (CUDA events, median over runs of 2 back-to-back calls, inputs on the "
        f"card); the profiler's device time {dev[1]:.3f} / {dev[2]:.3f} ms in "
        f"{len(kernels[1])} / {len(kernels[2])} distinct kernels; peak memory allocated "
        f"{peak:.3f} GiB above the phase's start; on {card()}")
    for name, ms in kernels[1][:8]:  # where the device time goes at subsample 1
        log(f"[device_floorplan kernel] {ms:8.3f} ms {ms / dev[1]:7.2%}  {name[:110]}")


def phase_pipeline_device(host_fps: float) -> dict:
    """``depth-pro-video-torch --geometry device`` over the pipeline phase's
    frames: first without ``ground.json`` (launches and files checked), then
    with the ground and framing cached, beside the host geometry with the
    ground cached, each timed as a whole run."""
    from PIL import Image

    frames = PIPELINE_DIR / "frames"
    (frames / "ground.json").unlink()
    geometry = []
    real_frame = pipeline.process_single_frame

    def timed_frame(*args, **kwargs):
        ok, dt = real_frame(*args, **kwargs)
        geometry.append(dt)
        return ok, dt

    def run(out: str, *flags) -> float:
        geometry.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_pipeline.main(["--frames_dir", str(frames), "--output_dir", str(PIPELINE_DIR / out),
                           "--batch_size", str(BATCH), "--num_workers", "4", *flags,
                           "--device", "cuda"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    pipeline.process_single_frame = timed_frame
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        wall = run("plans_device", "--geometry", "device")
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        geo = statistics.median(geometry)
        cached = run("plans_device_cached", "--geometry", "device")
        geo_cached = statistics.median(geometry)
        host_cached = run("plans_host_cached", "--renderer", "fast", *shape_flags()[0])
        geo_host = statistics.median(geometry)
    finally:
        pipeline.process_single_frame = real_frame
    forwards = pipeline_forwards(PIPELINE_FRAMES)
    log(f"[pipeline_device] depth-pro-video-torch --geometry device, large preset, bf16, batch "
        f"{BATCH}, 4 workers: {PIPELINE_FRAMES} frames of 1080x1920, {forwards} forwards, "
        f"launches {launches}; peak memory allocated {peak:.3f} GiB (the model, its batches and "
        f"up to 4 frames' programs at once)")
    plans = PIPELINE_DIR / "plans_device"
    progress = json.loads((plans / "processing_progress.json").read_text())
    names = [f"output_{i:06d}.png" for i in range(PIPELINE_FRAMES)]
    failed = [n for n in names if not progress.get(n, {}).get("success")]
    limits = json.loads((frames / "floorplan_limits.json").read_text())
    model = json.loads((frames / "ground.json").read_text())
    if failed or not limits.get("fingerprint") or not all(
            math.isfinite(v) for v in [*model["normal"], model["d"], *limits["x_limits"],
                                       *limits["z_limits"]]):
        raise AssertionError(f"pipeline_device: failed frames {failed}, limits {limits}, "
                             f"ground {model}")
    size = (DeviceFloorplanConfig(1080, 1920, tuple(limits["x_limits"]),
                                  tuple(limits["z_limits"])).raster_height, 1024, 3)
    for n in names:
        img = np.asarray(Image.open(plans / n.replace(".png", "_clean_simple_view.png")))
        if img.shape != size or img.dtype != np.uint8:
            raise AssertionError(f"pipeline_device: {n}'s plan is {img.shape} {img.dtype}, "
                                 f"not the raster's {size}")
    want = {name: n * forwards for name, n in PER_FORWARD["exact"].items()}
    if launches != want:
        raise AssertionError(f"pipeline_device: kernel launches {launches} != {want}")
    log(f"[pipeline_device] {PIPELINE_FRAMES} successes, floorplan_limits.json with its "
        f"fingerprint (x {[round(v, 3) for v in limits['x_limits']]}, z "
        f"{[round(v, 3) for v in limits['z_limits']]}), {PIPELINE_FRAMES} plans of {size}")
    log(f"[pipeline_device] frames/s over the whole run (ground fit included): device geometry "
        f"{PIPELINE_FRAMES / wall} ({wall:.3f} s), host geometry {host_fps} (the pipeline phase); "
        f"with the ground cached: device geometry {PIPELINE_FRAMES / cached} ({cached:.3f} s), "
        f"host geometry {PIPELINE_FRAMES / host_cached} ({host_cached:.3f} s); geometry median "
        f"per frame: device {geo:.4f} s (cached run {geo_cached:.4f} s), host {geo_host:.4f} s; "
        f"on {card()}")
    shutil.rmtree(PIPELINE_DIR)
    return launches


def phase_effect(scene: dict) -> dict:
    """Parallax frames and the anaglyph at 1080x1920, the card against the
    CPU path, then ``depth-pro-effect-torch`` end to end on one PNG."""
    import cv2
    from PIL import Image

    image, depth = scene["image"], scene["depth"]
    duration, fps = EFFECT_FRAMES
    total = int(duration * fps)
    phases = 2.0 * np.pi * np.arange(total, dtype=np.float32) / total
    few = [0, total // 3, 2 * total // 3]
    dn = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-9)
    img_t, dn_t = torch.from_numpy(image.astype(np.float32)), torch.from_numpy(dn)
    img_c, dn_c = img_t.cuda(), dn_t.cuda()
    for motion in parallax.MOTIONS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = parallax.parallax_frames(image, depth, duration, fps, 0.05, motion, device="cuda")
        wall = time.perf_counter() - t0
        want = parallax._parallax_chunk(img_t, dn_t, 0.05, torch.from_numpy(phases[few]),
                                        motion).numpy()
        diff = np.abs(got[few].astype(np.int16) - want)
        ts = torch.from_numpy(phases).cuda()
        render = median_ms(lambda: parallax._parallax_chunk(img_c, dn_c, 0.05, ts, motion),
                           iters=5, calls=1) / total
        log(f"[effect] parallax {motion}, {total} frames of 1080x1920: card against the CPU on "
            f"phases {few}: max |diff| {int(diff.max())}, {np.mean(diff > 0):.3e} of values "
            f"differ (fail above 1 or {EFFECT_SHARE:g}); {wall / total * 1e3:.3f} ms per frame "
            f"end to end (upload, render, fetch), {render:.3f} ms per frame rendering (CUDA "
            f"events); on {card()}")
        if diff.max() > 1 or np.mean(diff > 0) > EFFECT_SHARE:
            raise AssertionError(f"effect: parallax {motion} on the card disagrees with the CPU")
    got = parallax.anaglyph_image(image, depth, 0.05, device="cuda")
    diff = np.abs(got.astype(np.int16) - parallax.anaglyph_image(image, depth, 0.05, "cpu"))
    dx = torch.tensor(0.05 * image.shape[1], device="cuda")
    ana_ms = median_ms(lambda: parallax._anaglyph(img_c, dn_c, dx), iters=10)
    log(f"[effect] anaglyph 1080x1920: card against the CPU: max |diff| {int(diff.max())}, "
        f"{np.mean(diff > 0):.3e} of values differ; {ana_ms:.3f} ms (CUDA events)")
    if diff.max() > 1 or np.mean(diff > 0) > EFFECT_SHARE:
        raise AssertionError("effect: the anaglyph on the card disagrees with the CPU")
    shutil.rmtree(EFFECT_DIR, ignore_errors=True)
    EFFECT_DIR.mkdir(parents=True)
    backend = parallax.write_video(str(EFFECT_DIR / "direct.mp4"), got[None].repeat(2, 0), fps)
    if backend != "cv2":
        raise AssertionError(f"effect: write_video encoded with {backend}, not cv2")

    png, mp4, ana = (EFFECT_DIR / n for n in ("frame.png", "parallax.mp4", "anaglyph.png"))
    Image.fromarray(image).save(png)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    parallax.main(["--image_path", str(png), "--output_path", str(mp4), "--duration",
                   str(duration), "--fps", str(fps), "--device", "cuda"])
    t_parallax = time.perf_counter() - t0
    t0 = time.perf_counter()
    parallax.main(["--image_path", str(png), "--output_path", str(ana), "--effect", "anaglyph",
                   "--device", "cuda"])
    t_ana = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches()
    cap = cv2.VideoCapture(str(mp4))
    read = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        read.append(frame.shape)
    cap.release()
    plan = np.asarray(Image.open(ana))
    want = {name: n * 2 for name, n in PER_FORWARD["exact"].items()}  # one forward per image
    if (len(read) != total or set(read) != {(1080, 1920, 3)} or plan.shape != (1080, 1920, 3)
            or launches != want):
        raise AssertionError(f"effect CLI: {len(read)} frames read back (want {total}), shapes "
                             f"{set(read)}, anaglyph {plan.shape}, launches {launches} (want "
                             f"{want})")
    log(f"[effect] depth-pro-effect-torch, large preset: parallax mp4 of {total} frames "
        f"(1080x1920, cv2 reads them back) in {t_parallax:.3f} s, anaglyph PNG in {t_ana:.3f} s "
        f"(each with the model's build and one forward); launches {launches}")
    shutil.rmtree(EFFECT_DIR)
    return launches


def read_obj_counts(path: Path) -> tuple[int, int]:
    lines = path.read_text().splitlines()
    return (sum(line.startswith("v ") for line in lines),
            sum(line.startswith("f ") for line in lines))


def check_ground(path: Path, tag: str) -> dict:
    model = json.loads(path.read_text())
    if not all(math.isfinite(v) for v in [*model["normal"], model["d"], *model["origin"]]):
        raise AssertionError(f"tools: {tag}'s ground.json is not finite: {model}")
    return model


def check_ply(path: Path, tag: str) -> int:
    cloud = read_ply(str(path))
    if len(cloud) == 0 or not np.isfinite(cloud.points).all():
        raise AssertionError(f"tools: {tag}'s {path.name} holds {len(cloud)} points, finite "
                             f"{np.isfinite(cloud.points).all()}")
    return len(cloud)


def check_image(path: Path, tag: str) -> tuple:
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.size == 0:
        raise AssertionError(f"tools: {tag}'s {path.name} does not decode")
    return img.shape


def bounded_plan(plan, cells: list):
    """``create_direct_floorplan`` with its cell no smaller than the x / z
    extent of the points it draws (those at ``height_threshold`` or above)
    over ``FLOORPLAN_CELLS``; each cell taken is appended to ``cells``."""
    def call(points, output_path, **kwargs):
        if kwargs.get("height_threshold") is not None:
            points = points[points[:, 1] >= kwargs["height_threshold"]]
        extent = float(np.ptp(points[:, [0, 2]], axis=0).max()) if len(points) else 0.0
        kwargs["grid_resolution"] = max(kwargs["grid_resolution"], extent / FLOORPLAN_CELLS)
        cells.append(kwargs["grid_resolution"])
        return plan(points, output_path, **kwargs)
    return call


def cg_bound_ms(res: int, screened: bool) -> float:
    """The least time of one CG iteration on the card: as a function of fp32
    (res, res, res) grids, (x, r, p[, d]) -> (x, r, p), each input read once
    and each output written once, over the memory rate. Its ~20 operations a
    voxel would take 1/30 of that at the fp32 peak, so bytes bound it."""
    return (6 + screened) * res**3 * 4 / PEAK_BYTES * 1e3


def phase_poisson(scene: dict) -> None:
    """The screened Poisson CG of ``depth-pro-mesh-torch`` at depth 8 (256^3)
    on a cloud of the structured scene's true depth: the card against the CPU
    on the same system, iterations, marching tetrahedra's counts, times."""
    cloud = depth_to_3d(scene["depth"], scene["f_px"], image=scene["image"])
    down = mesh.voxel_downsample(cloud, POISSON_VOXEL)
    nrm = mesh.estimate_normals(down.points, radius=POISSON_VOXEL * 2)
    res = 2**POISSON_DEPTH
    origin, spacing = mesh._grid_frame(down.points, res)
    t0 = time.perf_counter()
    b, diag, _ = mesh._poisson_system(down.points, nrm, res, origin, spacing, POISSON_SCREEN)
    system_s = time.perf_counter() - t0
    solved, card_ms = {}, []
    for dev in ("cuda", "cpu"):
        bt = torch.as_tensor(b.astype(np.float32), device=dev)
        d = torch.as_tensor(diag.astype(np.float32), device=dev)
        for _ in range(3 if dev == "cuda" else 1):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            x, n = mesh._poisson_cg(bt, d, 300, 1e-6)
            end.record()
            torch.cuda.synchronize()
            if dev == "cuda":
                card_ms.append(start.elapsed_time(end))
            solved[dev] = (x.cpu().numpy().astype(np.float64), n, time.perf_counter() - t0)
        del bt, d, x
    (on_card, n_card, _), (cpu, n_cpu, cpu_s) = solved["cuda"], solved["cpu"]
    ms = statistics.median(card_ms)
    err = float(np.abs(on_card - cpu).max() / np.abs(cpu).max())
    ijk = np.clip(np.round((down.points - origin) / spacing).astype(np.int64), 0, res - 1)
    counts = {}
    for name, chi in (("card", on_card), ("cpu", cpu)):
        iso = float(np.mean(chi[ijk[:, 0], ijk[:, 1], ijk[:, 2]]))
        verts, faces = mesh.marching_tetrahedra(chi, iso, origin, spacing)
        counts[name] = (len(verts), len(faces))
    bound = cg_bound_ms(res, True)
    log(f"[poisson] {len(cloud)} points of the {scene['depth'].shape[0]}x"
        f"{scene['depth'].shape[1]} scene's true depth, {len(down)} after the {POISSON_VOXEL} m "
        f"voxels, screened (alpha {POISSON_SCREEN}) {res}^3: the card against the CPU on one "
        f"system: max |diff| {err:.3e} of max |chi| (fail above {POISSON_BOUND:g}); iterations "
        f"{n_card} / {n_cpu} (fail if more than 1 apart); marching tetrahedra (vertices, faces) "
        f"{counts['card']} / {counts['cpu']} (fail if not equal)")
    log(f"[poisson] the card's solve: {ms:.3f} ms for {n_card} iterations (CUDA events, median of "
        f"3; {', '.join(f'{v:.3f}' for v in card_ms)}), {ms / n_card:.4f} ms per iteration against "
        f"a bound of {bound:.4f} ms (7 fp32 {res}^3 grids read or written at {PEAK_BYTES / 1e12} "
        f"TB/s: {bound / (ms / n_card):.1%} of it); the CPU's {cpu_s:.3f} s on "
        f"{torch.get_num_threads()} threads; the host's system (splat, divergence) {system_s:.3f} "
        f"s; on {card()}")
    if err > POISSON_BOUND or abs(n_card - n_cpu) > 1 or counts["card"] != counts["cpu"]:
        raise AssertionError(f"poisson: the card disagrees with the CPU: {err}, {n_card} / "
                             f"{n_cpu} iterations, counts {counts}")


def phase_tools(scene: dict) -> dict:
    """The host tool CLIs on one large-preset bf16 runner on the card: the four
    that run the model (``depth-pro-{pointcloud,clean,mesh,floorplan}-torch``,
    through their functions with ``runner=``) on the structured scene's PNG,
    72 K1 and 3 K2 per forward; the Poisson solve (``phase_poisson``); then the
    three host CLIs through ``main``. The depth is random-weight depth: the
    checks prove the path (files written, decodable, finite), not the
    geometry. Returns the launches of the four CLIs' forwards."""
    from PIL import Image

    phase_t0 = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    png = TOOLS_DIR / "room.png"
    Image.fromarray(scene["image"]).save(png)
    t0 = time.perf_counter()
    # threads decode the one image: a spawned pool would start (~7 s here) inside every infer_one
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16", rng_seed=SEED,
                              decode_pool="thread", device="cuda")
    build_s = time.perf_counter() - t0
    out = {name: TOOLS_DIR / name for name in ("pointcloud", "clean", "mesh", "floorplan")}
    calls = {
        "pointcloud": lambda: img_to_pointcloud.create_normalized_pointcloud(
            str(png), str(out["pointcloud"] / "room.ply"), ground_params_dir=str(out["pointcloud"]),
            runner=runner),
        "clean": lambda: pointcloud_cleaner.process_image_to_clean_pointcloud(
            str(png), str(out["clean"]), runner=runner, **RANDOM_DEPTH_CLEAN),
        "mesh": lambda: pointcloud_to_mesh.process_image_to_mesh(
            str(png), str(out["mesh"] / "room_mesh.obj"), method="poisson", depth=POISSON_DEPTH,
            runner=runner, html=True, **RANDOM_DEPTH_CLEAN),
        "floorplan": lambda: depth_to_floorplan.depth_image_to_floorplan(
            str(png), str(out["floorplan"]), runner=runner),
    }
    forwards, solves, cells = [], [], []
    real_infer, real_solve = runner.infer_one, mesh._poisson_cg_device
    real_plan = depth_to_floorplan.create_direct_floorplan

    def timed(fn, into):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)  # both return host arrays: the card is done
            into.append((time.perf_counter() - t0, result))
            return result
        return call

    runner.infer_one = timed(real_infer, forwards)
    mesh._poisson_cg_device = timed(real_solve, solves)
    depth_to_floorplan.create_direct_floorplan = bounded_plan(real_plan, cells)
    launches, wall = {}, {}
    try:
        for name, call in calls.items():
            out[name].mkdir()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall[name] = time.perf_counter() - t0
            launches[name] = read_launches()
            log(f"[tools] {name}: {wall[name]:.3f} s, launches {launches[name]}")
    finally:
        runner.infer_one, mesh._poisson_cg_device = real_infer, real_solve
        depth_to_floorplan.create_direct_floorplan = real_plan
    del runner
    torch.cuda.empty_cache()
    want = dict(PER_FORWARD["exact"])
    if any(n != want for n in launches.values()) or len(forwards) != 4 or len(solves) != 1:
        raise AssertionError(f"tools: launches {launches} (want {want} each), {len(forwards)} "
                             f"forwards, {len(solves)} solves")
    depth = forwards[0][1]["depth"]
    points = check_ply(out["pointcloud"] / "room.ply", "pointcloud")
    kept = check_ply(out["clean"] / "room_clean.ply", "clean")
    preview = check_image(out["clean"] / "room_clean_preview.png", "clean")
    verts, faces = read_obj_counts(out["mesh"] / "room_mesh.obj")
    plan = check_image(out["floorplan"] / "room_floorplan.png", "floorplan")
    if faces == 0 or not (out["mesh"] / "room_mesh.html").stat().st_size:
        raise AssertionError(f"tools: the mesh has {verts} vertices and {faces} faces")
    check_image(out["mesh"] / "room_mesh_preview.png", "mesh")
    grounds = [check_ground(out[name] / "ground.json", name) for name in out]
    log(f"[tools] one large preset bf16 runner (built in {build_s:.3f} s), the structured scene's "
        f"1080x1920 PNG, random-weight depth in [{depth.min():.4g}, {depth.max():.4g}] m: launches "
        f"per CLI {launches}; pointcloud: {points} finite points; clean ({RANDOM_DEPTH_CLEAN}): "
        f"{kept} points, preview {preview}; mesh: {verts} vertices, {faces} faces, html and "
        f"preview written; floorplan ({cells[0]:.4g} m cells): PNG {plan}; ground.json finite "
        f"in all four (normal "
        f"{[round(v, 6) for v in grounds[0]['normal']]})")
    fwd = forwards[2][0]
    solve = solves[0][0]
    log(f"[tools] seconds per CLI (forward included): "
        f"{', '.join(f'{k} {v:.3f}' for k, v in wall.items())}; depth-pro-mesh-torch "
        f"(poisson, depth {POISSON_DEPTH}): forward {fwd:.3f} s, the solve {solve:.3f} s (upload, "
        f"CG, fetch), host geometry {wall['mesh'] - fwd - solve:.3f} s; on {card()}")

    phase_poisson(scene)

    ply, host = out["pointcloud"] / "room.ply", TOOLS_DIR / "host"
    host.mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        view_pointcloud.main([str(ply), "-o", str(host / "view.png"), "--html"])
        view_pointcloud.main([str(ply), "-o", str(host / "view.png"), "--view", "front"])
    html = (host / "view.html").stat().st_size
    view = check_image(host / "view.png", "view")
    if importlib.util.find_spec("matplotlib") is None:
        plans = "not run: matplotlib does not import here (it draws two of its four outputs)"
    else:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            floorplan.main([str(ply), "-o", str(host / "plans")])
        outs = dict(line.split(": ", 1) for line in printed.getvalue().strip().splitlines())
        if sorted(outs) != ["data", "direct", "floorplan", "simple"] or not all(
                os.path.getsize(v) for v in outs.values()):
            raise AssertionError(f"tools: depth-pro-ply-floorplan-torch wrote {outs}")
        plans = "4 outputs written (matplotlib imports here)"
    (host / "pred").mkdir()
    (host / "gt").mkdir()
    np.savez_compressed(host / "pred" / "room_depth.npz", depth=depth)
    np.savez_compressed(host / "gt" / "room.npz", depth=scene["depth"])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        eval_depth.main(["--pred", str(host / "pred"), "--gt", str(host / "gt")])
    metrics = json.loads(printed.getvalue().strip().splitlines()[-1])
    if metrics.get("n_images") != 1 or not all(
            math.isfinite(v) for v in metrics.values() if isinstance(v, float)):
        raise AssertionError(f"tools: depth-pro-eval-torch printed {metrics}")
    log(f"[tools] depth-pro-view-torch: html {html} bytes, front view {view}; "
        f"depth-pro-ply-floorplan-torch: {plans}; depth-pro-eval-torch (the runner's depth "
        f"against the scene's true depth, random weights): abs_rel {metrics['abs_rel']:.4g}, "
        f"SI_boundary_F1 {metrics['SI_boundary_F1']:.4g}, all finite; the phase took "
        f"{time.perf_counter() - phase_t0:.3f} s")
    shutil.rmtree(TOOLS_DIR)
    return {k: sum(n[k] for n in launches.values()) for k in want}


def vit_matmul_params(vit: ViTConfig) -> tuple[int, int]:
    """(weights, scales) of one ViT's block matmuls: the weights that
    ``quantize_vit_weights`` stores as int8 and their fp32 scales, one per
    (layer, output channel)."""
    d, hidden = vit.embed_dim, vit.mlp_ratio * vit.embed_dim
    weights = vit.depth * (d * 3 * d + d * d + d * hidden + hidden * d)
    scales = vit.depth * (3 * d + d + hidden + d)
    return weights, scales


def quantized_saving(cfg: DepthProConfig) -> int:
    """Bytes the int8 ViTs save over the fp32 master weights: 3 of every 4
    bytes of the block matmul weights, less the scales' 4 bytes each."""
    weights, scales = vit_matmul_params(cfg.vit)
    return (3 if cfg.use_fov_head else 2) * (3 * weights - 4 * scales)


def param_bytes(runner: DepthVideoRunner) -> int:
    return sum(nbytes(p) for p in runner.model.parameters())


def percentiles(values: list) -> tuple[float, float]:
    """(p50, p95), linear interpolation."""
    p50, p95 = np.percentile(np.asarray(values, np.float64), [50, 95])
    return float(p50), float(p95)


def parse_metrics(text: str) -> dict:
    """Prometheus text -> {name: value} for the lines without labels."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#") and "{" not in line:
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def post_depth(url: str, body: bytes, query: str = "") -> tuple[float, dict, bytes]:
    """POST one image; (seconds, headers, body). A status other than 200 raises."""
    req = urllib.request.Request(url + "/v1/depth" + query, data=body,
                                 headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        headers, raw = dict(r.headers), r.read()
    return time.perf_counter() - t0, headers, raw


def decode_npz(raw: bytes) -> tuple[np.ndarray, dict]:
    import base64

    payload = json.loads(raw)
    with np.load(io.BytesIO(base64.b64decode(payload["npz_base64"]))) as z:
        return z["depth"], payload


def check_payload(p: dict, shape: tuple, tag: str) -> None:
    if (p["depth_shape"] != list(shape) or not 0 < p["depth_min"] <= p["depth_max"] < math.inf
            or not math.isfinite(p["focallength_px"])):
        raise AssertionError(f"{tag}: bad response {p}")


def png_bytes(image: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def host_ms(fn, runs: int = 5) -> float:
    """Median host milliseconds of ``fn()`` over ``runs`` calls, after one."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def count_process_starts(fn) -> tuple[object, int]:
    """(``fn()``, the number of ``multiprocessing`` processes started during
    it: pool workers and other ``Process`` objects, and the resource tracker
    that the first semaphore of a spawn context starts)."""
    from multiprocessing import process, resource_tracker

    starts = []
    real = process.BaseProcess.start
    tracker = resource_tracker._resource_tracker._pid

    def counting(self):
        starts.append(self)
        return real(self)

    process.BaseProcess.start = counting
    try:
        out = fn()
    finally:
        process.BaseProcess.start = real
    started_tracker = tracker is None and resource_tracker._resource_tracker._pid is not None
    return out, len(starts) + started_tracker


def phase_serve(image: np.ndarray):
    """``create_server`` at the large preset, driven over HTTP from this
    process. Returns (launches, the server's runner, its build's bytes)."""
    from PIL import Image

    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    srv = create_server(port=0, model="large", max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                        warmup_shape=image.shape[:2], device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = read_launches()
    runner = srv.batcher.runner
    built = torch.cuda.memory_allocated() - mem0
    if warm != PER_FORWARD["exact"] or runner.decode_pool != "thread":
        raise AssertionError(f"serve: warm-up launches {warm}, decode pool {runner.decode_pool}")
    log(f"[serve] create_server (large, bf16, max_batch {SERVE_BATCH}, max_wait_ms "
        f"{SERVE_WAIT_MS}, warm-up on) in {build_s:.3f} s; the warm-up's forward launched "
        f"{warm}; memory_allocated grew {built / 2**30:.4f} GiB (parameters "
        f"{param_bytes(runner) / 2**30:.4f} GiB, fp32 master weights)")
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    body = png_bytes(image)
    rng = np.random.default_rng(SEED + 9)
    stream = [png_bytes(np.clip(image.astype(np.int16) + rng.integers(-3, 4, image.shape), 0, 255)
                        .astype(np.uint8)) for _ in range(SERVE_SESSION)]

    def traffic():
        lone, sent = [], 0
        for _ in range(SERVE_LONE):
            dt, _, raw = post_depth(url, body, "?return=json")
            check_payload(json.loads(raw), image.shape[:2], "serve lone")
            lone.append(dt)
        sent += SERVE_LONE
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
            loaded = list(pool.map(lambda _: post_depth(url, body, "?return=json"),
                                   range(SERVE_REQUESTS)))
        wall = time.perf_counter() - t0
        sent += SERVE_REQUESTS
        for _, _, raw in loaded:
            check_payload(json.loads(raw), image.shape[:2], "serve concurrency 8")
        depth, p_npz = decode_npz(post_depth(url, body, "?return=npz")[2])
        _, headers, raw = post_depth(url, body, "?return=png16")
        plain = [decode_npz(post_depth(url, f, "?return=npz")[2])[0] for f in stream]
        smoothed = [decode_npz(post_depth(url, f, "?return=npz&session=s&smooth=0.8")[2])
                    for f in stream]
        sent += 2 + 2 * SERVE_SESSION
        return lone, [r[0] for r in loaded], wall, depth, p_npz, headers, raw, plain, smoothed, sent

    torch.cuda.synchronize()
    reset_launches()
    result, starts = count_process_starts(traffic)
    torch.cuda.synchronize()
    launches = read_launches()
    lone, loaded, wall, depth, p_npz, headers, png16, plain, smoothed, sent = result
    with urllib.request.urlopen(url + "/metrics") as r:
        metrics = parse_metrics(r.read().decode())
    forwards = int(metrics["depthpro_batches_total"])
    want = {name: n * forwards for name, n in PER_FORWARD["exact"].items()}
    log(f"[serve] {sent} requests of one {image.shape[0]}x{image.shape[1]} PNG, {forwards} forwards (/metrics), "
        f"launches {launches}, processes started {starts}")
    if metrics["depthpro_requests_total"] != sent or metrics["depthpro_request_errors_total"]:
        raise AssertionError(f"serve: /metrics counts {metrics['depthpro_requests_total']} "
                             f"requests, {metrics['depthpro_request_errors_total']} errors; "
                             f"{sent} sent")
    if launches != want or starts:
        raise AssertionError(f"serve: launches {launches} != {want}, or {starts} processes")

    if (depth.shape != image.shape[:2] or not np.isfinite(depth).all() or not (depth > 0).all()
            or float(depth.min()) != p_npz["depth_min"] or float(depth.max()) != p_npz["depth_max"]):
        raise AssertionError(f"serve: npz depth {depth.shape} against json {p_npz}")
    img16 = np.asarray(Image.open(io.BytesIO(png16)))
    scale = [float(headers[k]) for k in ("X-Depth-Min", "X-Depth-Max", "X-Focallength-Px")]
    if (img16.shape != image.shape[:2] or img16.dtype != np.uint16 or abs(scale[0] - depth.min())
            > 1e-6 * depth.max() or abs(scale[1] - depth.max()) > 1e-6 * depth.max()
            or abs(scale[2] - p_npz["focallength_px"]) > 1e-3):
        raise AssertionError(f"serve: png16 {img16.shape} {img16.dtype}, headers {scale}")
    smoother = TemporalSmoother(alpha=SMOOTH_ALPHA, host=True)
    worst = 0.0
    for i, (raw_depth, (got, payload)) in enumerate(zip(plain, smoothed)):
        ref = smoother.update(raw_depth)
        worst = max(worst, float(np.max(np.abs(got.astype(np.float64) - ref) / np.abs(ref))))
        if payload["smooth_seeded"] is not (i == 0):
            raise AssertionError(f"serve: frame {i} smooth_seeded {payload['smooth_seeded']}")
    blended = float(np.mean(smoothed[-1][0] != plain[-1]))
    log(f"[serve] depth {depth.shape} finite and positive, range [{depth.min():.4g}, "
        f"{depth.max():.4g}] m, f_px {p_npz['focallength_px']:.2f}; npz equals json's min and "
        f"max; png16 decodes (uint16) with X-Depth-Min/Max and X-Focallength-Px; session stream "
        f"of {SERVE_SESSION} against the host twin over the unsmoothed responses: largest "
        f"relative difference {worst:.3e} (fail above {SERVE_SMOOTH_BOUND:g}), "
        f"{blended:.4f} of the last frame's pixels smoothed")
    if worst > SERVE_SMOOTH_BOUND:
        raise AssertionError(f"serve: session stream off the host twin by {worst:.3e}")

    size = runner.cfg.img_size
    ref = runner.infer_one(canonicalize(image, size))
    ref_depth, ref_f = restore(ref["depth"], ref["focallength_px"], *image.shape[:2], size)
    dev = float(np.max(np.abs(ref_depth - depth)) / np.max(np.abs(ref_depth)))
    f_dev = abs(ref_f - p_npz["focallength_px"]) / abs(ref_f)
    log(f"[serve] a lone request against runner.infer_one on the host-canonicalised frame, "
        f"resized back: max |diff| {dev:.3e} of scale, f_px {f_dev:.3e} relative (fail above "
        f"{SERVE_REF_BOUND:g})")
    if not (dev <= SERVE_REF_BOUND and f_dev <= SERVE_REF_BOUND):
        raise AssertionError(f"serve: server depth off infer_one by {dev:.3e} / {f_dev:.3e}")

    p50_1, p95_1 = percentiles(lone)
    p50_8, p95_8 = percentiles(loaded)
    fill = metrics["depthpro_batch_fill_ratio"]
    host = {"PNG decode": host_ms(lambda: np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))),
            "canonical resize": host_ms(lambda: canonicalize(image, size)),
            "resize back": host_ms(lambda: restore(ref["depth"], 1.0, *image.shape[:2], size)),
            "npz encode": host_ms(lambda: encode_npz(depth)),
            "png16 encode": host_ms(lambda: encode_png16(depth))}
    log(f"[serve] latency at concurrency 1 (a lone request padded to a batch of {SERVE_BATCH}): "
        f"p50 {p50_1 * 1e3:.1f} ms, p95 {p95_1 * 1e3:.1f} ms over {SERVE_LONE}; at concurrency "
        f"{SERVE_CONCURRENCY}: {SERVE_REQUESTS / wall:.3f} requests/s, p50 {p50_8 * 1e3:.1f} ms, "
        f"p95 {p95_8 * 1e3:.1f} ms over {SERVE_REQUESTS}; batch fill ratio {fill:.4f} over "
        f"{forwards} batches; on {card()}")
    log(f"[serve] host ms per {image.shape[0]}x{image.shape[1]} request (median of 5, one "
        "thread): "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    setup = {}
    for pool in ("thread", "process"):
        runner.decode_pool = pool
        ms, started = count_process_starts(lambda: host_ms(lambda: list(runner.depth_stream([])),
                                                           runs=10))
        setup[pool] = (ms, started)
    runner.decode_pool = "thread"
    log(f"[serve] the runner's per-batch set-up and tear-down of its loader (depth_stream of no "
        f"frames, median of 10): thread pool (the server's) {setup['thread'][0]:.3f} ms, "
        f"{setup['thread'][1]} processes started; spawn process pool (decode_pool='auto' on "
        f"this host's {os.cpu_count()} CPUs) {setup['process'][0]:.3f} ms, "
        f"{setup['process'][1]} processes started")
    srv.shutdown()
    srv.server_close()
    thread.join(30)
    return launches, runner, built


def phase_quantize(plain: DepthVideoRunner, plain_built: int, exact_fps: float) -> dict:
    """The int8 weight-only ViT on the large preset: memory beside the fp32
    master weights, launches, deviation from the unquantized runner's
    canonical inverse depth, frames/s; the tiny config on the card against
    the CPU."""
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16", batch_size=BATCH,
                              rng_seed=SEED, quantize=True, device="cuda")
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - mem0
    saved, want_saved = param_bytes(plain) - param_bytes(runner), quantized_saving(runner.cfg)
    log(f"[quantize] memory_allocated after the build: int8 ViTs {built / 2**30:.4f} GiB "
        f"(parameters {param_bytes(runner) / 2**30:.4f} GiB) against the fp32 master weights' "
        f"{plain_built / 2**30:.4f} GiB (parameters {param_bytes(plain) / 2**30:.4f} GiB): "
        f"{(plain_built - built) / 1e9:.4f} GB less allocated, {saved / 1e9:.4f} GB less in "
        f"parameters; predicted {want_saved / 1e9:.4f} GB")
    # the build holds its parameters and nothing more: no fp32 copy of the quantized weights
    if saved != want_saved or abs(built - param_bytes(runner)) > QUANT_SAVING_SLACK * want_saved:
        raise AssertionError(f"quantize: {saved} bytes saved in parameters (predicted "
                             f"{want_saved}); the build allocated {built} for "
                             f"{param_bytes(runner)} of parameters")
    rng = np.random.default_rng(SEED + 10)
    frames = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(4)]
    torch.cuda.synchronize()
    reset_launches()
    results = list(runner.depth_stream(frames))
    torch.cuda.synchronize()
    launches = read_launches()
    forwards = math.ceil(len(frames) / BATCH)
    want = {name: n * forwards for name, n in PER_FORWARD["exact"].items()}
    log(f"[quantize] large preset, bf16, batch {BATCH}, quantize: {len(results)} frames, "
        f"{forwards} forwards, launches {launches}")
    check_results(results, len(frames), "quantize")
    if launches != want:
        raise AssertionError(f"quantize: kernel launches {launches} != {want}")

    cfg = runner.cfg
    frame = torch.from_numpy(frames[0][None]).cuda()
    x = resize2d(frame.float() / 127.5 - 1.0, (cfg.img_size, cfg.img_size))
    with torch.inference_mode():
        cq, _ = forward(runner.params, x, cfg, Precision.bf16(), compute_fov=False)
        cp, _ = forward(plain.params, x, cfg, Precision.bf16(), compute_fov=False)
    cq, cp = cq.float(), cp.float()
    if not (torch.isfinite(cq).all() and torch.isfinite(cp).all()):
        raise AssertionError("quantize: non-finite canonical inverse depth")
    dev = ((cq - cp).abs() / cp.abs().max().clamp_min(1e-30)).flatten()
    med, p99, mx = (torch.quantile(dev[::4], 0.5).item(), torch.quantile(dev[::4], 0.99).item(),
                    dev.max().item())
    log(f"[quantize] int8 against bf16 canonical inverse depth (share of scale, random weights): "
        f"median {med:.3e} p99 {p99:.3e} max {mx:.3e}; fail above {QUANT_MAX_DEV}; the JAX "
        f"package's chip figure with its checkpoint: median {TPU_QUANT_MEDIAN:.0e} added to "
        f"bf16's own (not enforced)")
    if mx > QUANT_MAX_DEV:
        raise AssertionError(f"quantize: deviation {mx:.3e} above {QUANT_MAX_DEV}")
    pool = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(8)]
    fps = frames_per_s(runner, [pool[i % len(pool)] for i in range(TIMED_FRAMES)], BATCH)
    log(f"[quantize] {fps} frames/s over {TIMED_FRAMES} frames (batch {BATCH}, bf16, int8 ViTs), "
        f"beside the exact slice's {exact_fps}; on {card()}")
    del runner

    tiny = tiny_config()
    cpu = init_depth_pro(tiny, torch.Generator().manual_seed(SEED), "cpu")
    q_cpu = quantize_vit_weights(cpu)
    q_gpu = quantize_vit_weights(map_tree(lambda t: t.cuda(), cpu))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(_leaves(q_gpu), _leaves(q_cpu)))
    if not same:
        raise AssertionError("quantize: int8 codes or scales differ between the card and the CPU")
    img = torch.from_numpy(rng.standard_normal((1, 300, 410, 3)).astype(np.float32))
    with torch.inference_mode():
        ref = infer_fn(q_cpu, img, None, tiny, Precision.fp32())
        got = infer_fn(q_gpu, img.cuda(), None, tiny, Precision.fp32())
    torch.testing.assert_close(got["depth"].cpu(), ref["depth"], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got["focallength_px"].cpu(), ref["focallength_px"], rtol=1e-3,
                               atol=1e-4)
    log("[quantize] tiny config: int8 codes and scales quantized on the card equal the CPU's; "
        "the quantized fp32 forward, card (K1) against the CPU plain path: depth and f_px within "
        "rtol 1e-3 / atol 1e-4")
    torch.cuda.empty_cache()
    return launches


def _leaves(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


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


def first_batch_s(frames: list, **kwargs) -> tuple[DepthVideoRunner, float]:
    """A fresh large-preset runner (bf16, batch ``BATCH``, seed ``SEED``) and
    the seconds from its build to the end of its first batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = DepthVideoRunner(cfg=model_preset("large"), precision="bf16", batch_size=BATCH,
                              rng_seed=SEED, decode_pool="thread", device="cuda", **kwargs)
    sum(1 for _ in runner.depth_stream(frames[:BATCH]))
    torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def phase_export() -> dict:
    """``depth-pro-export-torch`` at the large preset for exact and balanced;
    each artifact served by a fresh runner against an eager one."""
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 11)
    size = model_preset("large").img_size
    frames = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(EXPORT_FRAMES)]
    window = [frames[i % len(frames)] for i in range(EXPORT_TIMED)]
    forwards = math.ceil(EXPORT_FRAMES / BATCH)
    total = {name: 0 for name in KERNELS}
    for speed in ("exact", "balanced"):
        tag = f"export {speed}"
        path = EXPORT_DIR / f"large_{speed}.pt2"
        t0 = time.perf_counter()
        export_main(["-o", str(path), "--model", "large", "--precision", "bf16", "--batch_size",
                     str(BATCH), "--speed", speed, "--device", "cuda"])
        export_s = time.perf_counter() - t0
        cfg = model_preset("large") if speed == "exact" else apply_speed(model_preset("large"),
                                                                         speed)
        t0 = time.perf_counter()
        load_exported(str(path), cfg, "bf16", quantize=False, n_devices=1, device="cuda").module()
        load_s = time.perf_counter() - t0
        served, served_first = first_batch_s(frames, speed=speed, exported_path=str(path))
        eager, eager_first = first_batch_s(frames, speed=speed)
        calls = served.exported_calls
        torch.cuda.synchronize()
        reset_launches()
        got = list(served.depth_stream(frames))
        torch.cuda.synchronize()
        launches = read_launches()
        calls = served.exported_calls - calls
        want = {name: n * forwards for name, n in PER_FORWARD[speed].items()}
        if launches != want or calls != forwards:
            raise AssertionError(f"{tag}: launches {launches} (want {want}), {calls} of "
                                 f"{forwards} forwards through the artifact")
        ref = list(eager.depth_stream(frames))
        if eager.exported_calls:
            raise AssertionError(f"{tag}: the eager runner called an artifact")
        diff = max(float(np.abs(g["depth"] - r["depth"]).max()) for g, r in zip(got, ref))
        f_diff = max(abs(g["focallength_px"] - r["focallength_px"]) for g, r in zip(got, ref))
        same = all(np.array_equal(g["depth"], r["depth"])
                   and g["focallength_px"] == r["focallength_px"] for g, r in zip(got, ref))
        log(f"[{tag}] {EXPORT_FRAMES} frames of {size}x{size} through the artifact: launches "
            f"{launches} ({forwards} forwards, all {calls} through it); against the eager "
            f"runner: equal bit for bit {same} (max |depth diff| {diff:.3e} m, |f_px diff| "
            f"{f_diff:.3e})")
        if not same:
            again = list(eager.depth_stream(frames))
            eager_same = all(np.array_equal(a["depth"], r["depth"]) for a, r in zip(again, ref))
            raise AssertionError(f"{tag}: the artifact's depth differs from the eager runner's "
                                 f"(max {diff:.3e} m); the eager runner against itself: equal "
                                 f"{eager_same}")
        fps = frames_per_s(served, window, BATCH)
        eager_fps = frames_per_s(eager, window, BATCH)
        log(f"[{tag}] export {export_s:.3f} s, load {load_s:.3f} s, artifact "
            f"{path.stat().st_size} bytes; first batch of a fresh runner (build + {BATCH} "
            f"frames): {served_first:.3f} s with the artifact, {eager_first:.3f} s without; "
            f"frames/s over {EXPORT_TIMED} frames: {fps} with, {eager_fps} without "
            f"(large, bf16, batch {BATCH}) on {card()}")
        total = {name: total[name] + launches[name] for name in KERNELS}
        del served, eager
        torch.cuda.empty_cache()
    shutil.rmtree(EXPORT_DIR)
    return total


def main() -> int:
    device = phase_device()
    phase_build()
    report = phase_kernels()
    runner, exact, exact_fps = run_slice("exact")
    phase_accuracy(runner)
    paths = {"exact": exact, "maps": phase_maps(runner, exact_fps)}
    del runner
    for speed in ("balanced", "fast"):
        runner, paths[speed], _ = run_slice(speed)
        del runner
    paths["multi_head_attention"] = phase_unpacked_entry()
    phase_speed_accuracy()
    paths["pipeline"], host_fps = phase_pipeline(exact_fps)
    scene = structured_scene(1080, 1920, SCENE_F_PX, SEED + 8)
    phase_device_floorplan(scene)
    paths["pipeline_device"] = phase_pipeline_device(host_fps)
    paths["effect"] = phase_effect(scene)
    paths["tools"] = phase_tools(scene)
    paths["serve"], serve_runner, serve_built = phase_serve(scene["image"])
    paths["quantize"] = phase_quantize(serve_runner, serve_built, exact_fps)
    del serve_runner
    torch.cuda.empty_cache()
    paths["maps_cli"] = phase_maps_cli()  # its decode pool's processes come and go
    paths["export"] = phase_export()
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
