"""On-card smoke test of the PyTorch/CUDA port (``ml_depth_pro_video_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
``nvcc``::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: torch/CUDA versions, card name and power limit (nvidia-smi);
2. build: the CUDA kernels are compiled from ``csrc/*.cu``, one nvcc per
   source, all started together (seconds timed); ``cuobjdump -sass`` of the
   library must show wgmma (HGMMA), TMA loads (UTMALDG) and no mma.sync
   (HMMA) in the four instances of K1, K3 and K4's bf16 body
   (``csrc/attention_wgmma.cu``: 64 or 128 queries a block, with or without
   a bias) and in the two of K2's wgmma body (``csrc/resblock_wgmma.cu``),
   counts printed;
3. kernels: K1 (packed attention), K2 (fused resblock), K3 (packed attention
   with a per-key bias, -inf keys included) and K4 (attention on (B, H, S, D))
   against their plain PyTorch versions on the card at the shapes the paths
   give them and at ragged ones, and K5 (the ViT block's residual add with
   LayerScale and the LayerNorm after it, ``ops/norm.py``) in each of its
   three modes at the patch and image ViTs' residual streams, its ``x_new``
   equal to the plain composition's bit for bit, with the error bound stated; each timed
   with CUDA events beside its plain version, beside one PyTorch call that
   computes the same function where there is one (``library_ms``:
   ``scaled_dot_product_attention`` on the same views, a yardstick the port
   never calls) and beside its bound (the larger of its bytes over 3.35 TB/s
   and its operations over the card's peak for their type); the attention
   kernels' entries carry the fp32 (parity mode) reading at the same shape
   under ``fp32``, K1's the bf16 one at the image ViT's (2, 577, 3072)
   under ``small_shape``, at the latency path's patch slice (18, 577, 3072)
   under ``latency_shape`` (K3's at (18, 289, 3072) too) and at the
   ``train_parallel`` phase's shapes under ``dp_shape`` (35, 577, 3072),
   ``tp_shape`` (70, 577, 1536, 8 heads) and ``pp_shape`` (14, 577, 3072);
   each K1, K3 and K4 line and entry names the body and tile it took
   (``body``: ``wgmma`` for bf16 at head dim 64, which every model shape must
   take; ``tile``: queries per block x keys per tile), K1's ``small_shape`` entry
   carries the profiler's device time under ``device_ms``, and K4 must
   equal K1 bit for bit on the same q, k, v at (70, 577, 3072) and at
   ragged sequence lengths; and K2's (2,
   96, 96, 256) entry its (2, 48, 48, 256) reading there and the latency
   path's bands plus halo, (1, 26, 48, 256) and (1, 50, 96, 256), under
   ``latency_shape_26x48`` and ``latency_shape_50x96``; K2 is also timed
   beside the plain composition at the 192^2 and 384^2 levels that the
   width gate keeps on the plain path, each K2 line and entry names the body
   and the output tile it took (``body``: ``wgmma`` at 256 channels, which
   every model shape must take; ``tile``: rows x columns), and K2's entries carry the
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
   weights: the artifact holds none) for ``--speed exact``, and
   ``export_infer`` the ``--speed balanced`` one at ``EXPORT_CUT`` (the large
   widths at the ToMe proxy's depth: 8 blocks, hooks after blocks 1 and 3);
   for each, a fresh ``DepthVideoRunner(exported_path=...)`` streams 4 frames
   of 1536x1536 uint8 through ``depth_stream``: every forward must go through
   the artifact (``exported_calls``), launching 72 K1 and 3 K2 (exact) or 18
   K1, 6 K3 and 3 K2 (balanced at 8 blocks), and depth and f_px must equal an
   eager runner's with the same params on the same frames bit for bit.
   Printed beside the card's name and power limit: export and load seconds,
   the artifact's bytes, the first-batch latency of a fresh runner (its build
   and its first batch of 2) with the artifact and without it, and frames/s of
   both over the same 32-frame window.
8b. parallel: two ranks on the one card, one gloo group (``parallel/``; NCCL
   refuses two ranks on one device), started as ``chip_smoke.py
   --parallel-rank r port dir`` while this process exports a ``--dp 2``
   artifact at ``EXPORT_CUT`` (exact, batch 2); each rank shares one param
   tree (random, seed 0) among its runners and runs in turn: (a)
   ``depth-pro-maps-torch --coordinator ... --num_processes 2`` over the
   pipeline phase's 8 frames of 1080x1920 (large, bf16, exact, batch 2: one
   frame per rank), the npz maps equal bit for bit to the unsharded runner's
   at batch 1; (b) the runner in latency mode at batch 1, exact and fast: the
   attention shapes per rank ((18, 577, 3072) for the 35 patches padded to
   36, (1, 577, 3072) for the image and FOV ViTs; K3 at (18, 289, 3072) at
   fast) and K2 on the bands plus halo, the depth against the unsharded
   runner within ``LATENCY_ENVELOPE``, where its max lies and how its top 1%
   crowd the rows where the bands meet; one 1536^2 frame's canonical inverse
   depth through ``forward`` (unclamped) against the unsharded forward, beside
   the control: the same with the halo zeroed at one decoder level, each
   level in turn; the sound map must not read as a halo error
   (``HALO_FAULT``) and every control must; ms per frame beside the unsharded
   runner's; the gathers and the point-to-point halo exchanges per forward
   and their synchronised ms; (c) ``depth-pro-video-torch`` over 2 ranks: one
   ``ground.json``, per-rank progress files covering every frame once, the
   plans decodable; (d) ``create_server(parallel="dp")``: rank 0 answers 4
   requests, rank 1 follows its batches; the answers equal the unsharded
   runner's at the per-rank batch bit for bit (within ``SERVE_REF_BOUND``);
   (e) the artifact served by a 2-rank dp runner, equal to the eager dp runner
   bit for bit. Launches per rank per forward: 72 K1 / 3 K2 (dp, latency
   exact), 50 K1 / 22 K3 / 3 K2 (latency fast), 24 K1 / 3 K2 (the artifact);
   printed beside the card's name and power limit: dp frames/s at batch 4,
   each rank's peak memory.
   Both ranks share the card's SMs: the numbers are the parallel machinery's
   overhead, not a speedup;
8c. train_parallel: first ``fit`` on one rank (the reference below), then
   two ranks on the one card over gloo, started as
   ``chip_smoke.py --train-parallel-rank r port dir``, each building the
   ``large`` params from seed 0 (the final head bias raised by 0.5) and
   decoding the same global batch of 2 of 6 ``write_dataset`` pairs at
   1536^2: the canonical maps of the one-rank forward and of dp, tp and pp
   make the conditioned target (``conditioned_depth``); rank 0 takes the
   one-rank step's loss and gradients and frees them from the card; then one
   step (bf16 on fp32 masters, clipped AdamW) through the step that
   ``make_train_step`` returns, of dp=2 (a row per rank), tp=2 (8 of 16 heads
   per rank: K1 at (70, 577, 1536)) and pp=2 (12 blocks per stage, 5
   microbatches: K1 at (14, 577, 3072)), each with its K1 shapes and
   launches per rank per step checked (``train_parallel_shapes``; 3 K2); the
   gradients the step hands to AdamW, gathered, held against the one-rank
   step's with the ``train`` phase's comparator, and each leaf the mode
   splits by its own norm; the global norm against the gathered gradient's
   and the updated params against the one-rank AdamW on those gradients;
   the leaves every rank holds whole, params and moments, equal on both;
   s/step split into gradients and AdamW, the collectives' calls and
   synchronised ms, and the peak memory per rank; the tp=2 state saved once
   by rank 0 in the one-rank layout and restored, equal to the gathered state
   and, re-cut, to each rank's bit for bit; last, ``fit`` over both ranks
   (dp=2, fp32: 2 steps, a holdout of 2 validated in lock-step, a checkpoint
   at the end, restored equal bit for bit), its losses and val_silog held
   against the one-rank ``fit``'s, 96 K1 per step. Both ranks share
   the card's SMs and their collectives go through host memory: the
   machinery's cost, not a speedup;
9. train: the plain backward of K1 at (70, 577, 3072) and of K2 at (2, 96,
   96, 256) timed beside their forwards; then ``fit`` (``train/loop.py``) at
   the ``large`` preset, bf16, 1536^2, batch 2, random weights from seed 0, on
   8 pairs of 512^2 written by ``utils/synthetic.py::write_dataset``: 4 steps
   with checkpoints every 2 and a metrics file, 96 K1 and 3 K2 per step,
   finite losses; s/step after the first, peak memory, the checkpoint's
   bytes and save / restore seconds, the restored state equal bit for bit, and
   a resumed ``fit`` that continues to step 8; one step split into forward,
   backward and optimizer (CUDA events); one loss + backward with the kernels
   against the plain versions routed in (loss and flattened gradient, with
   the final head bias raised by 0.5, beside the plain bf16 path against
   fp32); one fp32 ``train_step`` of the tiny config, card against CPU;
10. distill: ``distill`` (``train/distill.py``) with a ``large`` teacher runner
   over 4 frames of 512^2, then the ``small`` student's ``fit`` for 2 steps:
   4 labels, 48 K1 and 3 K2 per student step, s/step.

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
import re
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
from ml_depth_pro_video_tpu_torch.ckpt.checkpointing import restore_train_state
from ml_depth_pro_video_tpu_torch.ckpt.convert import save_params
from ml_depth_pro_video_tpu_torch.ckpt.export import export_infer, load_exported
from ml_depth_pro_video_tpu_torch.ckpt.export import main as export_main
from ml_depth_pro_video_tpu_torch.ckpt.params import (
    _map_with_path,
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
from ml_depth_pro_video_tpu_torch.kernels import loader
from ml_depth_pro_video_tpu_torch.kernels.loader import load_library
from ml_depth_pro_video_tpu_torch.models import depth_pro as depth_pro_module
from ml_depth_pro_video_tpu_torch.models import vit as vit_module
from ml_depth_pro_video_tpu_torch.models.depth_pro import (
    DepthProConfig,
    apply_speed,
    build_params,
    forward,
    infer_fn,
    load_checkpoint,
    model_preset,
    tiny_config,
)
from ml_depth_pro_video_tpu_torch.models.vit import ViTConfig
from ml_depth_pro_video_tpu_torch.ops.attention import (
    K1,
    K3,
    K4,
    _split_packed,
    attention_body,
    attention_packed,
    attention_packed_op,
    attention_packed_reference,
    attention_reference,
    multi_head_attention,
)
from ml_depth_pro_video_tpu_torch.ops.norm import (
    K5,
    add_layer_norm,
    add_layer_norm_reference,
    layer_norm_reference,
)
from ml_depth_pro_video_tpu_torch.ops.resblock import (
    FUSED_MAX_WIDTH,
    K2,
    fused_residual_block,
    k2_body,
    residual_block_reference,
)
from ml_depth_pro_video_tpu_torch.train import distill as distill_module
from ml_depth_pro_video_tpu_torch.train import loop as loop_module
from ml_depth_pro_video_tpu_torch.train.data import DepthDataset
from ml_depth_pro_video_tpu_torch.train.step import (
    TrainState,
    loss_fn,
    make_optimizer,
    make_train_step,
    tree_leaves,
    value_and_grad,
)
from ml_depth_pro_video_tpu_torch.ops.resize import resize2d
from ml_depth_pro_video_tpu_torch.parallel.latency import patch_split
from ml_depth_pro_video_tpu_torch.serve.server import (
    canonicalize,
    create_server,
    encode_npz,
    encode_png16,
    restore,
)
from ml_depth_pro_video_tpu_torch.video import pipeline
from ml_depth_pro_video_tpu_torch.video.pack import max_rel_error, pack_depth_u16, unpack_depth_u16
from ml_depth_pro_video_tpu_torch.utils.synthetic import FAMILIES, write_dataset
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from ml_depth_pro_video_tpu_torch.video.temporal import (
    TemporalSmoother,
    _update_core_np,
    smooth_batch,
)

SEED = 0
BATCH = 2  # the slice's batch size: K1 sees (35*BATCH, 577, 3072) and (BATCH, 577, 3072)
KERNELS = {"K1": K1, "K2": K2, "K3": K3, "K4": K4, "K5": K5}
# slice shapes at batch 1 and at BATCH, the latency slice over 2 ranks, the train_parallel
# phase's tp-local heads at BATCH (8 of 16 per rank) and its pp microbatch (70 patch rows / 5),
# then ragged ones; (2, 65, 192) with 2 heads is hd=32
K1_SHAPES = [((35 * BATCH, 577, 3072), 16), ((BATCH, 577, 3072), 16), ((35, 577, 3072), 16),
             ((1, 577, 3072), 16), ((18, 577, 3072), 16), ((35 * BATCH, 577, 1536), 8),
             ((BATCH, 577, 1536), 8), ((14, 577, 3072), 16), ((3, 33, 192), 4),
             ((2, 65, 384), 2), ((2, 65, 192), 2)]
# the report key of each further K1 shape timed in bf16 (the top level is (35 * BATCH, 577, 3072))
K1_REPORT = {(BATCH, 577, 3072): "small_shape", (18, 577, 3072): "latency_shape",
             (35, 577, 3072): "dp_shape", (35 * BATCH, 577, 1536): "tp_shape",
             (14, 577, 3072): "pp_shape"}
# the speed tiers' patch-ViT shapes (balanced keeps 433 of 577 tokens, fast 289) at BATCH
# and at batch 1, the latency path's slice at fast over 2 ranks, then ragged ones
K3_SHAPES = [((35 * BATCH, 433, 3072), 16), ((35 * BATCH, 289, 3072), 16),
             ((35, 433, 3072), 16), ((35, 289, 3072), 16), ((18, 289, 3072), 16),
             ((3, 33, 192), 4), ((2, 65, 192), 2)]
# a ViT-L block's attention in (B, H, S, D) at batch 2 and 1, then ragged ones
K4_SHAPES = [(35 * BATCH, 16, 577, 64), (35, 16, 577, 64), (3, 4, 33, 32), (2, 2, 65, 16)]
ATTN_BOUNDS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # share of scale, TF32 off
ATTN_KEYS_PER_TILE = 64  # every attention body's key tile
# the SASS opcodes counted in the wgmma body: wgmma, TMA loads, mma.sync, ldmatrix
SASS_OPCODES = ("HGMMA", "UTMALDG", "HMMA", "LDSM")
# K4 against K1 on the same q, k, v, bit for bit: the batch-2 patch ViT, then ragged sequence
# lengths on a grid of 128-query blocks and on one of 64-query blocks
K4_EQUAL_SHAPES = [((35 * BATCH, 577, 3072), 16), ((24, 129, 3072), 16), ((2, 65, 384), 2)]
# the decoder's K2 levels at BATCH and batch 1, the latency path's bands plus halo over 2 ranks,
# then ragged ones, then the levels the width gate keeps on the plain composition (timed beside it)
K2_SHAPES = [(BATCH, 48, 48, 256), (BATCH, 96, 96, 256), (1, 48, 48, 256), (1, 26, 48, 256),
             (1, 50, 96, 256), (1, 20, 24, 64), (BATCH, 9, 7, 24), (BATCH, 192, 192, 256),
             (BATCH, 384, 384, 256)]
TIMED_FRAMES = 96  # the fps window: ~6 s at the large preset, after a warm-up stream
K2_BOUND = 2e-2  # bf16 tap-accumulation band of the JAX package's own test
# K5 per ViT pass: 3 a block (models/vit.py::_block: the first LayerNorm, the attention residual
# with the second, the MLP residual), 1 for the final norm
PER_FORWARD = {  # kernel launches per forward of the large preset
    # 24 blocks x 3 ViTs; 3 decoder resblocks; K5: 3 x (72 + 1)
    "exact": {"K1": 72, "K2": 3, "K3": 0, "K4": 0, "K5": 219},
    # patch ViT blocks 0-1 exact, the merge, blocks 2-23 with the size bias; image and FOV
    # ViTs exact
    "balanced": {"K1": 50, "K2": 3, "K3": 22, "K4": 0, "K5": 219},
    "fast": {"K1": 50, "K2": 3, "K3": 22, "K4": 0, "K5": 219},
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
# the balanced artifact at the ToMe proxy's depth (8 blocks, hooks after blocks 1 and 3) and the
# large preset's widths: its export and load take a third of the large artifact's; the exact
# artifact stays at large
EXPORT_CUT = dataclasses.replace(model_preset("large"),
                                 vit=dataclasses.replace(model_preset("large").vit, depth=8),
                                 hook_block_ids=(1, 3))
# per forward of EXPORT_CUT at balanced: patch ViT blocks 0-1 exact, the merge, blocks 2-7 with
# the size bias; image and FOV ViTs 8 blocks each. K5: 3 x (3 x 8 + 1)
EXPORT_CUT_PER_FORWARD = {"K1": 18, "K2": 3, "K3": 6, "K4": 0, "K5": 75}
# ... and at exact (the parallel phase's --dp 2 artifact): 8 blocks x 3 ViTs
PARALLEL_EXPORT_PER_FORWARD = {"K1": 24, "K2": 3, "K3": 0, "K4": 0, "K5": 75}
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"  # ignored by git
TRAIN_PAIRS = 8  # write_dataset pairs of 512^2, resized to 1536^2 by DepthDataset: 4 steps at BATCH
# per training step of the large preset (loss_fn: remat, no FOV head): 24 blocks x 2 ViTs in the
# forward and again in the per-block recompute of the backward; the 3 decoder resblocks (48^2,
# 96^2, 96^2) once, not recomputed. Backward through K1, K2 and K5 is the plain math (no
# kernel). K5: 2 x (3 x 24 + 1) in the forward, and the 3 of each of the 48 blocks again in
# the recompute (the final norm is outside the recomputed blocks)
PER_TRAIN_STEP = {"K1": 96, "K2": 3, "K3": 0, "K4": 0, "K5": 290}
# the small student (ViT-S, 12 blocks, 6 heads x 64; decoder 96 wide): 12 x 2 x 2 K1, 3 K2;
# K5: 2 x (3 x 12 + 1), then 3 x 24 recomputed
PER_STUDENT_STEP = {"K1": 48, "K2": 3, "K3": 0, "K4": 0, "K5": 146}
DISTILL_FRAMES = 4  # labelled by a large teacher at BATCH: 2 forwards; the student takes 2 steps
# one loss + backward with the kernels against the same with the plain versions routed in (large,
# bf16, batch 2, the trained params): the loss's relative difference, the flattened gradient's
# relative L2 distance and cosine, on the well-conditioned pixels (conditioned_depth)
TRAIN_LOSS_BOUND, TRAIN_GRAD_L2, TRAIN_GRAD_COS = 1e-2, 5e-2, 0.99
# a step across ranks against the one-rank AdamW on the same gathered gradients: the global norm
# relative to the gathered gradient's, and the params' largest difference (1e-2 of the lr: a
# clip factor off by 2x moves the params whose clipped gradient sits near AdamW's eps by up to
# half the lr; rounding leaves an ulp)
TRAIN_NORM_REL, TRAIN_UPDATE_BOUND = 1e-4, 1e-6
SILOG_EPS = 1e-6  # train/step.py::silog_loss's clamp of the canonical inverse depth
# the tiny fp32 step: the card against the CPU, loss and every gradient leaf
TINY_LOSS_RTOL, TINY_GRAD_RTOL, TINY_GRAD_ATOL = 1e-4, 1e-3, 1e-4
# conditioned_depth's bound for the tiny step: the p99 of the two devices' relative difference in
# the canonical map on this case is 3.4e-5; the pixels beyond it sit next to the head's ReLU 0, and
# at 1e-4 (1e-3) two (45,560) gradient elements of the raw params fall outside rtol 1e-3 / atol
# 1e-4 (scripts/torch_train_probe.py --tiny; PERF.md)
TINY_CONDITIONING = 3e-5
PARALLEL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"  # ignored by git
PARALLEL_RANKS = 2  # one gloo group of 2 ranks on the one card
PARALLEL_MODEL, PARALLEL_DEVICE = "large", "cuda"
PARALLEL_FRAMES, PARALLEL_SHAPE = PIPELINE_FRAMES, (1080, 1920)  # the pipeline phase's frames
PARALLEL_EXPORT = EXPORT_CUT  # the --dp 2 artifact: the large widths at 8 blocks, exact
PARALLEL_BATCH = 2  # the maps, pipeline and export steps' batch: 1 frame per rank
LATENCY_FRAMES = 4  # the latency runs at batch 1: 2 counted forwards, 4 timed frames
DP_TIMED = 16  # the dp runner's frames/s window (batch SERVE_BATCH: 2 frames per rank)
PARALLEL_TIMEOUT = 900  # seconds for the two ranks' steps
# the bf16 envelope of ROADMAP.md (the JAX package's TPU figure), share of scale: the latency
# path against the unsharded runner, inverse depth
LATENCY_ENVELOPE = {"p99": 4.6e-3, "max": 1.09e-2}
# what reads as a halo error in the latency path against the unsharded one (PERF.md §6, on the
# card): a canonical inverse depth off by more than "max" of scale, or a top 1% of pixels more
# than "crowding" times as dense near the band cut as elsewhere. The sound path reads 8.946e-3
# and 0.92 (the runner's depth 0.99-1.01); a halo zeroed at any one decoder level 1.104e-1 to
# 4.356e-1 and 5.85 to 12.00, its max within 6 rows of the cut. Every run checks both sides
HALO_FAULT = {"max": 3e-2, "crowding": 3.0}
LEVELS = (2, 4, 8, 16, 32)  # the decoder's levels in token grids: fused low-res .. finest
DEPTH_CLAMP_INV = 1.0001e-4  # inverse depth at the runner's 1e4 m clamp (and a rounding above)
TRAIN_PARALLEL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train_parallel"
TRAIN_PARALLEL_RANKS = 2  # one gloo group of 2 ranks on the one card
# the pairs written: the steps' global batch is the first BATCH of them shuffled; fit holds out
# TRAIN_PARALLEL_HOLDOUT and trains on the rest, a step per BATCH
TRAIN_PARALLEL_PAIRS, TRAIN_PARALLEL_HOLDOUT = 6, 2
# fp32, and the first update at the warmup's lr 0: from the random init AdamW's updates (near
# sign(g)) move every param by the lr, LayerScale to 10x its init, and a second such update turns
# the two runs' rounding into two trajectories (val_silog 3.662e-02 apart in bf16, 3.108e-01 in
# fp32; PERF.md); one update keeps them within 2.1e-05 in fp32
TRAIN_PARALLEL_FIT = dict(batch_size=BATCH, epochs=1, lr=1e-4, warmup_steps=1,
                          holdout=TRAIN_PARALLEL_HOLDOUT, log_every=1, seed=SEED,
                          precision=Precision.fp32())
# one step of each on the global batch of BATCH: 1 row per rank, every row on half the heads,
# the patch ViT's 24 blocks as 2 stages of 12 over 5 microbatches of 14 patch rows
TRAIN_PARALLEL_MODES = {"dp": dict(dp=2), "tp": dict(tp=2), "pp": dict(pp=2, microbatches=5)}
TRAIN_PARALLEL_TIMEOUT = 600  # seconds for the two ranks


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


def device_ms(fn, calls: int = 10, tries: int = 3) -> float:
    """Device time of one call: its kernels' own time summed by the profiler
    over ``calls`` calls, without the gaps where the card waits on the host.
    A profile that holds no kernel time (the profiler can come back with no
    kernel records) is taken again, up to ``tries`` profiles; if none holds
    any, this raises rather than return a time of 0."""
    for _ in range(tries):
        ms = sum(ms for _, ms in kernel_times(fn, calls))
        if ms > 0:
            return ms
    raise RuntimeError(f"the profiler recorded no kernel time in {tries} profiles of {calls} "
                       "calls each")


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


def body_fields(body: str, rows: int) -> dict:
    """The attention body a call took and its tile: queries per block x keys per tile."""
    return {"body": body, "tile": f"{rows}x{ATTN_KEYS_PER_TILE}"}


def attention_body_checked(b: int, s: int, heads: int, hd: int, dtype, tag: str) -> dict:
    """``body_fields`` of a K1, K3 or K4 call; a bf16 call at head dim 64
    (every model shape) must take the wgmma body."""
    fields = body_fields(*attention_body(b, s, heads, hd, dtype))
    if dtype == torch.bfloat16 and hd == 64 and fields["body"] != "wgmma":
        raise AssertionError(f"{tag}: bf16 hd=64 took the {fields['body']} body, not wgmma")
    return fields


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


# "/*0b40*/  @!P0 HGMMA.64x64x16.F32.BF16 R24, ..." -> HGMMA
_SASS_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")


def sass_counts(sass: str, opcodes=SASS_OPCODES) -> dict:
    """{mangled function: {opcode: count}} of ``cuobjdump -sass`` output, for
    the opcodes named (the part of each instruction before its first dot)."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = counts.setdefault(m.group(1), dict.fromkeys(opcodes, 0))
        elif fn is not None and (m := _SASS_INSTRUCTION.match(line)):
            if m.group(1) in fn:
                fn[m.group(1)] += 1
    return counts


# the Hopper bodies' kernels and their instance counts: K1, K3 and K4's (64 or 128 queries a
# block, with or without a bias) and K2's (two tiles)
WGMMA_KERNELS = {"attention_wgmma_kernel": 4, "resblock_wgmma_kernel": 2}


def check_wgmma_sass(counts: dict) -> None:
    """Each Hopper body's instances, all there, run on the tensor cores
    through wgmma (HGMMA) alone (no mma.sync, HMMA) and load by TMA (UTMALDG)."""
    for kernel, n in WGMMA_KERNELS.items():
        found = {fn: c for fn, c in counts.items() if kernel in fn}
        if len(found) != n or not all(c["HGMMA"] and c["UTMALDG"] and not c["HMMA"]
                                      for c in found.values()):
            raise AssertionError(f"{kernel}: {len(found)} instances of {n}, or SASS without "
                                 f"HGMMA and UTMALDG or with HMMA: {found}")


def check_sass() -> None:
    """The built library's SASS: the Hopper bodies of K1, K3, K4 and K2 must
    run on wgmma and load by TMA (``check_wgmma_sass``)."""
    tool = Path(loader._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(loader.library_path())], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = sass_counts(sass)
    for fn, c in sorted(counts.items()):
        if any(kernel in fn for kernel in WGMMA_KERNELS):
            log(f"[build] cuobjdump -sass {fn}: " + ", ".join(f"{n} {op}" for op, n in c.items()))
    check_wgmma_sass(counts)


def phase_build() -> None:
    t0 = time.perf_counter()
    load_library()
    log(f"[build] kernels built from csrc/*.cu and loaded in {time.perf_counter() - t0:.1f} s")
    check_sass()


def _check(name: str, rel: float, limit: float, line: str) -> None:
    log(line)
    if not rel <= limit:
        raise AssertionError(f"{name}: rel error {rel:.3e} above bound {limit:g}")


def kernels_k1(g) -> dict:
    report = {}
    for shape, heads in K1_SHAPES:
        base = torch.randn(shape, generator=g, device="cuda")
        b, s, d3 = shape
        hd = d3 // 3 // heads
        for dtype in (torch.bfloat16, torch.float32):
            qkv = base.to(dtype)
            got = attention_packed(qkv, heads)
            ref = attention_packed_reference(qkv, heads)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            fields = attention_body_checked(b, s, heads, hd, dtype, f"K1 {dtype} {shape}")
            line = (f"[kernels] K1 attention_packed {dtype} {shape} heads={heads} "
                    f"[{fields['body']} body, {fields['tile']} tile]: "
                    f"max_abs_err={err:.3e} rel={rel:.3e} (bound {ATTN_BOUNDS[dtype]:g})")
            if s == 577:
                kernel = lambda: attention_packed(qkv, heads)  # noqa: E731
                times, suffix = timed(kernel, lambda: attention_packed_reference(qkv, heads),
                                      sdpa_on(*_split_packed(qkv, heads)),
                                      attention_flops(b, heads, s, hd), nbytes(qkv, got), dtype)
                line += suffix
                if shape == (35 * BATCH, 577, 3072):
                    add_to_report(report, err, rel, {**times, **fields}, shape, dtype)
                elif dtype == torch.bfloat16 and shape in K1_REPORT:
                    if K1_REPORT[shape] == "small_shape":  # host-bound: its device time apart
                        times["device_ms"] = device_ms(kernel)
                        line += f"; device {times['device_ms']:.4f} ms"
                    report[K1_REPORT[shape]] = report_entry(err, rel, {**times, **fields}, shape,
                                                            dtype)
            _check(f"K1 {dtype} {shape}", rel, ATTN_BOUNDS[dtype], line)
    # K4 is K1's kernel body read through other strides: the same bits
    for shape, heads in K4_EQUAL_SHAPES:
        b, s, d3 = shape
        qkv = torch.randn(shape, generator=g, device="cuda").bfloat16()
        q, k, v = (t.contiguous() for t in _split_packed(qkv, heads))
        same = torch.equal(attention_packed(qkv, heads),
                           multi_head_attention(q, k, v).transpose(1, 2).reshape(b, s, d3 // 3))
        log(f"[kernels] K4 on the unpacked q, k, v equals K1 on the packed qkv {shape} "
            f"heads={heads} bit for bit: {same}")
        if not same:
            raise AssertionError(f"K4 and K1 disagree on the same data at {shape}")
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
            b, s, d3 = shape
            fields = attention_body_checked(b, s, heads, d3 // 3 // heads, dtype,
                                            f"K3 {dtype} {shape}")
            line = (f"[kernels] K3 attention_packed_bias {dtype} {shape} heads={heads} "
                    f"[{fields['body']} body, {fields['tile']} tile]: "
                    f"max_abs_err={err:.3e} rel={rel:.3e} (bound {ATTN_BOUNDS[dtype]:g})")
            if d3 == 3072:
                times, suffix = timed(lambda: attention_packed(qkv, heads, bias),
                                      lambda: attention_packed_reference(qkv, heads, bias),
                                      sdpa_on(*_split_packed(qkv, heads), bias),
                                      attention_flops(b, heads, s, d3 // 3 // heads),
                                      nbytes(qkv, bias, got), dtype)
                line += suffix
                times.update(fields)
                if shape[:2] == (35 * BATCH, 433):
                    add_to_report(report, err, rel, times, shape, dtype)
                elif dtype == torch.bfloat16 and shape[:2] == (35 * BATCH, 289):
                    report["fast_shape"] = report_entry(err, rel, times, shape, dtype)
                elif dtype == torch.bfloat16 and shape[0] == 18:
                    # the latency path's patch slice at fast over 2 ranks
                    report["latency_shape"] = report_entry(err, rel, times, shape, dtype)
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
        fields = attention_body_checked(b, s, heads, 64, dtype, f"K3 {dtype} -inf keys")
        got = attention_packed(qkv, heads, bias)
        ref = attention_packed_reference(qkv, heads, bias)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and (got[2] == 0).all()):
            raise AssertionError(f"K3 {dtype}: NaN or a non-zero row under an all -inf bias")
        err, rel = rel_err(got[:2], ref[:2])
        _check(f"K3 {dtype} -inf keys", rel, ATTN_BOUNDS[dtype],
               f"[kernels] K3 {dtype} [{fields['body']} body] -inf bias on a whole key tile "
               f"and on scattered keys: "
               f"max_abs_err={err:.3e} rel={rel:.3e}; on every key of an item: finite zeros")
    return report


def kernels_k4(g) -> dict:
    report = {}
    for shape in K4_SHAPES:
        bases = [torch.randn(shape, generator=g, device="cuda") for _ in range(3)]
        b, h, s, hd = shape
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in bases)
            got = multi_head_attention(q, k, v)
            ref = attention_reference(q, k, v)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            fields = attention_body_checked(b, s, h, hd, dtype, f"K4 {dtype} {shape}")
            line = (f"[kernels] K4 attention_bhsd {dtype} {shape} [{fields['body']} body, "
                    f"{fields['tile']} tile]: max_abs_err={err:.3e} rel={rel:.3e} "
                    f"(bound {ATTN_BOUNDS[dtype]:g})")
            if s == 577:
                times, suffix = timed(lambda: multi_head_attention(q, k, v),
                                      lambda: attention_reference(q, k, v), sdpa_on(q, k, v),
                                      attention_flops(*shape), nbytes(q, k, v, got), dtype)
                line += suffix
                if b == 35 * BATCH:
                    add_to_report(report, err, rel, {**times, **fields}, shape, dtype)
            _check(f"K4 {dtype} {shape}", rel, ATTN_BOUNDS[dtype], line)
    return report


def resblock_flops(b: int, h: int, w: int, c: int) -> float:
    return 2 * 2.0 * b * h * w * 9 * c * c  # two 3x3 convolutions, C -> C


def k2_body_checked(shape: tuple) -> dict:
    """The body and output tile K2 takes at ``shape``; at 256 channels (every
    model shape) it must be the wgmma body."""
    body, (th, tw) = k2_body(*shape)
    if shape[-1] == 256 and body != "wgmma":
        raise AssertionError(f"K2 {shape}: 256 channels took the {body} body, not wgmma")
    return {"body": body, "tile": f"{th}x{tw}"}


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
        fields = k2_body_checked(shape)
        line = (f"[kernels] K2 resblock bf16 {shape} [{fields['body']} body, {fields['tile']} "
                f"tiles]: max_abs_err={err:.3e} rel={rel:.3e} (bound {K2_BOUND:g})")
        if c == 256:
            # two 3x3 convolutions; no single PyTorch call computes the whole block
            kernel = lambda: fused_residual_block(x, w1, b1, w2, b2)  # noqa: E731
            plain = lambda: residual_block_reference(x, w1, b1, w2, b2)  # noqa: E731
            times, suffix = timed(kernel, plain, None, resblock_flops(*shape),
                                  nbytes(x, w1, b1, w2, b2, got), torch.bfloat16)
            # the plain composition's launches wait on the host: its device time apart
            times["device_ms"], times["plain_device_ms"] = device_ms(kernel), device_ms(plain)
            times.update(fields)
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
            elif b == 1 and h in (26, 50):  # the latency path's bands plus halo
                report[f"latency_shape_{h}x{w}"] = report_entry(err, rel, times, shape,
                                                                torch.bfloat16)
        log(line)
        if not rel < K2_BOUND:
            raise AssertionError(f"K2 {shape}: rel error {rel:.3e} above bound")
    return report


# K5 at the patch ViT's residual stream at BATCH (exact, then fast) and the image ViT's
K5_SHAPES = [(35 * BATCH * 577, 1024), (35 * BATCH * 289, 1024), (BATCH * 577, 1024)]
K5_MODES = {"add_norm": (True, True), "norm": (False, True), "add": (True, False)}
K5_ULPS = 1  # bf16 ulps per element (the statistics are summed in another order)


def bf16_ulps(y: torch.Tensor, want: torch.Tensor, bias: torch.Tensor) -> float:
    """Largest |y - want| over elements, in bf16 ulps (2^(e - 7) for a value in
    [2^e, 2^(e+1))) at the larger of |want| and |bias|: where the normalised
    value times the gain and the bias nearly cancel, the rounding of those
    terms outweighs the small output's own ulp."""
    scale = torch.maximum(want.float().abs(), bias.float().abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((y.float() - want.float()).abs() / ulp).max().item()


def kernels_k5(g) -> dict:
    """K5 in each mode against the plain composition: ``x_new`` bit for bit,
    each element of the LayerNorm output within ``K5_ULPS`` bf16 ulps
    (``bf16_ulps``); timed beside it at the exact patch ViT's shape, the add
    and LayerNorm mode's entry at the top level."""
    report = {}
    for shape in K5_SHAPES:
        rows, d = shape
        for mode, (add, norm) in K5_MODES.items():
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(torch.bfloat16)
            branch = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) if add
                      else None)
            ls = torch.rand(d, generator=g, device="cuda") if add else None
            gain = torch.randn(d, generator=g, device="cuda") if norm else None
            bias = torch.randn(d, generator=g, device="cuda") * 0.1 if norm else None
            ins = (x, branch, ls, gain, bias)
            got, ref = add_layer_norm(*ins), add_layer_norm_reference(*ins)
            torch.cuda.synchronize()
            if add and not torch.equal(got[0], ref[0]):
                raise AssertionError(f"K5 {mode} {shape}: x_new differs from torch.addcmul's")
            err, rel = rel_err(got[1], ref[1]) if norm else (0.0, 0.0)
            ulps = bf16_ulps(got[1], ref[1], bias) if norm else 0.0
            line = (f"[kernels] K5 add_layer_norm {mode} bf16 {shape}: x_new "
                    f"{'equal' if add else 'not computed'}, LayerNorm max_abs_err={err:.3e} "
                    f"rel={rel:.3e}, {ulps:g} bf16 ulps at most (bound {K5_ULPS})")
            if rows == 35 * BATCH * 577:
                moved = nbytes(*(t for t in ins if t is not None)) + nbytes(
                    *(t for t in (got[0] if add else None, got[1]) if t is not None))
                times, suffix = timed(lambda: add_layer_norm(*ins),
                                      lambda: add_layer_norm_reference(*ins), None,
                                      8.0 * rows * d, moved, torch.bfloat16)
                line += suffix
                if mode == "add_norm":
                    report.update(report_entry(err, rel, times, shape, torch.bfloat16))
                else:
                    report[mode] = report_entry(err, rel, times, shape, torch.bfloat16)
            log(line)
            if not ulps <= K5_ULPS:
                raise AssertionError(f"K5 {mode} {shape}: LayerNorm output {ulps:g} bf16 ulps "
                                     f"off, above {K5_ULPS}")
    return report


def phase_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(SEED)
    return {"K1": kernels_k1(g), "K2": kernels_k2(g), "K3": kernels_k3(g), "K4": kernels_k4(g),
            "K5": kernels_k5(g)}


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
    if launches != {"K1": 0, "K2": 0, "K3": 0, "K4": 1, "K5": 0} or not torch.isfinite(out).all():
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


def first_batch_s(frames: list, cfg: DepthProConfig, **kwargs) -> tuple[DepthVideoRunner, float]:
    """A fresh runner of ``cfg`` (bf16, batch ``BATCH``, seed ``SEED``) and
    the seconds from its build to the end of its first batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = DepthVideoRunner(cfg=cfg, precision="bf16", batch_size=BATCH,
                              rng_seed=SEED, decode_pool="thread", device="cuda", **kwargs)
    sum(1 for _ in runner.depth_stream(frames[:BATCH]))
    torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def phase_export() -> dict:
    """``depth-pro-export-torch`` at the large preset for exact, and
    ``export_infer`` at ``EXPORT_CUT`` (large widths, 8 blocks) for
    balanced; each artifact served by a fresh runner against an eager one."""
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
        base = model_preset("large") if speed == "exact" else EXPORT_CUT
        path = EXPORT_DIR / f"{'large' if speed == 'exact' else 'depth8'}_{speed}.pt2"
        t0 = time.perf_counter()
        if speed == "exact":
            export_main(["-o", str(path), "--model", "large", "--precision", "bf16",
                         "--batch_size", str(BATCH), "--speed", speed, "--device", "cuda"])
        else:
            export_infer(apply_speed(base, speed), "bf16", BATCH, str(path), device="cuda")
        export_s = time.perf_counter() - t0
        cfg = base if speed == "exact" else apply_speed(base, speed)
        t0 = time.perf_counter()
        load_exported(str(path), cfg, "bf16", quantize=False, n_devices=1, device="cuda").module()
        load_s = time.perf_counter() - t0
        served, served_first = first_batch_s(frames, base, speed=speed, exported_path=str(path))
        eager, eager_first = first_batch_s(frames, base, speed=speed)
        calls = served.exported_calls
        torch.cuda.synchronize()
        reset_launches()
        got = list(served.depth_stream(frames))
        torch.cuda.synchronize()
        launches = read_launches()
        calls = served.exported_calls - calls
        per_forward = PER_FORWARD[speed] if speed == "exact" else EXPORT_CUT_PER_FORWARD
        want = {name: n * forwards for name, n in per_forward.items()}
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
            f"({'large' if speed == 'exact' else 'large widths, 8 blocks'}, bf16, batch {BATCH}) "
            f"on {card()}")
        total = {name: total[name] + launches[name] for name in KERNELS}
        del served, eager
        torch.cuda.empty_cache()
    shutil.rmtree(EXPORT_DIR)
    return total


# ---------------------------------------------------------------------------
# training (train/*.py)


@contextlib.contextmanager
def instrumented_fit(steps: list, saves: list):
    """Record each training step's seconds and kernel launches, and each
    checkpoint save's (step, seconds), of the ``fit`` runs inside, through the loop
    module's own names (``make_train_step``, ``save_train_state``), which
    ``fit`` looks up when it calls them. A step's time ends in a
    ``synchronize``, as ``fit``'s own ``float(loss)`` does."""
    real_make, real_save = loop_module.make_train_step, loop_module.save_train_state

    def make(*args, **kwargs):
        state, step = real_make(*args, **kwargs)

        def timed(state, images, depth):
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, images, depth)
            torch.cuda.synchronize()
            after = read_launches()
            steps.append({"s": time.perf_counter() - t0,
                          "launches": {k: after[k] - before[k] for k in after}})
            return out

        return state, timed

    def save(directory, state, step, *args, **kwargs):
        t0 = time.perf_counter()
        real_save(directory, state, step, *args, **kwargs)
        saves.append((step, time.perf_counter() - t0))  # a step saved again is a no-op

    loop_module.make_train_step, loop_module.save_train_state = make, save
    try:
        yield
    finally:
        loop_module.make_train_step, loop_module.save_train_state = real_make, real_save


def state_bytes(directory: Path, step: int) -> int:
    return sum(f.stat().st_size for f in (directory / str(step)).iterdir())


def states_equal(a, b) -> bool:
    """Params, both moments, the update count and the data step, bit for bit."""
    pa, pb = tree_leaves(a.params), tree_leaves(b.params)
    pairs = list(zip(pa, pb)) + list(zip(a.opt_state.mu, b.opt_state.mu)) + list(
        zip(a.opt_state.nu, b.opt_state.nu))
    return (a.step == b.step and a.opt_state.count == b.opt_state.count and len(pa) == len(pb)
            and all(torch.equal(x, y) for x, y in pairs))


def grad_agreement(got: list, ref: list) -> tuple[float, float]:
    """(relative L2 distance, cosine) of two flattened gradients (``None``
    leaves are zeros), summed per leaf in float64."""
    dd = rr = gg = gr = 0.0
    for g, r in zip(got, ref):
        if (g is None) != (r is None):
            raise AssertionError("the two gradients reach different leaves")
        if g is None:
            continue
        g, r = g.double(), r.double()
        dd += float(((g - r) ** 2).sum())
        rr += float((r * r).sum())
        gg += float((g * g).sum())
        gr += float((g * r).sum())
    return math.sqrt(dd / rr), gr / math.sqrt(gg * rr)


def plain_backward_ms() -> dict:
    """The backward (plain math, as the JAX custom VJPs) of K1 at the patch
    ViT's (70, 577, 3072) and of K2 at (2, 96, 96, 256), bf16, beside their
    forwards: CUDA events over back-to-back calls."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    qkv = torch.randn((35 * BATCH, 577, 3072), generator=g, device="cuda").bfloat16()
    qkv.requires_grad_()
    out = attention_packed_op(qkv, 16)
    ct = torch.randn(out.shape, generator=g, device="cuda").bfloat16()
    k1 = {"forward_ms": median_ms(lambda: attention_packed_op(qkv.detach(), 16)),
          "backward_ms": median_ms(lambda: torch.autograd.grad(out, qkv, ct, retain_graph=True))}
    x = (torch.randn((BATCH, 96, 96, 256), generator=g, device="cuda") * 0.5).bfloat16()
    w1, w2 = (torch.randn((3, 3, 256, 256), generator=g, device="cuda") * (9 * 256) ** -0.5
              for _ in range(2))
    b1, b2 = (torch.zeros(256, device="cuda") for _ in range(2))
    ins = [t.requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = fused_residual_block(*ins)
    cy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    k2 = {"forward_ms": median_ms(lambda: fused_residual_block(*(t.detach() for t in ins))),
          "backward_ms": median_ms(lambda: torch.autograd.grad(y, ins, cy, retain_graph=True))}
    log(f"[train] backward (plain math) beside the forward kernel, bf16: K1 (70, 577, 3072) "
        f"forward {k1['forward_ms']:.3f} ms, backward {k1['backward_ms']:.3f} ms; K2 (2, 96, 96, "
        f"256) forward {k2['forward_ms']:.3f} ms, backward {k2['backward_ms']:.3f} ms")
    return {"K1": k1, "K2": k2}


def split_step(state, cfg, batch) -> dict:
    """One step of ``state`` split into forward (``loss_fn``), backward
    (``torch.autograd.grad``) and optimizer (AdamW, the fit's settings), CUDA
    events, after a warm-up step."""
    opt = make_optimizer(1e-4, warmup_steps=1, total_steps=TRAIN_PAIRS // BATCH)
    images, depth = batch
    leaves = tree_leaves(state.params)
    times = {}
    for _ in range(2):  # the second is read
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = loss_fn(state.params, images, depth, cfg, Precision.bf16())
        ev[1].record()
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        ev[2].record()
        opt.update(grads, state.opt_state, state.params)
        ev[3].record()
        torch.cuda.synchronize()
        del grads, loss
        times = {"forward_ms": ev[0].elapsed_time(ev[1]), "backward_ms": ev[1].elapsed_time(ev[2]),
                 "optimizer_ms": ev[2].elapsed_time(ev[3])}
    return times


@contextlib.contextmanager
def routed(plain: bool):
    """With ``plain``, the ViT attention, its residual adds and LayerNorms and
    the decoder residual blocks routed to their plain versions (the module
    names the model code looks up), and a check that nothing inside launched
    a kernel."""
    names = {(vit_module, "attention_packed"): attention_packed_reference,
             (vit_module, "add_layer_norm"): add_layer_norm_reference,
             (vit_module, "layer_norm"): layer_norm_reference,
             (depth_pro_module, "residual_block"): residual_block_reference}
    real = {key: getattr(*key) for key in names}
    if plain:
        for (module, name), fn in names.items():
            setattr(module, name, fn)
    try:
        before = read_launches()
        yield
        torch.cuda.synchronize()
        if plain and read_launches() != before:
            raise AssertionError("the plain run launched a kernel")
    finally:
        for (module, name), fn in real.items():
            setattr(module, name, fn)


# the three runs held against each other: (precision, plain versions routed in)
TRAIN_RUNS = {"kernels": (Precision.bf16(), False), "plain": (Precision.bf16(), True),
              "fp32": (Precision.fp32(), True)}


def conditioned_depth(depth: torch.Tensor, maps: list, rel: float) -> tuple:
    """``depth`` with its ill-conditioned pixels made holes (0, which the loss
    leaves out), and the share of pixels so left out. ``maps`` are the
    compared runs' canonical inverse depth at the same pixels. The loss's
    gradient at a pixel scales with 1/c: where the runs' values of c differ by
    more than ``rel`` of the smallest, or one run has c at or below the
    loss's clamp, rounding next to the head's ReLU 0 alone makes that
    pixel's gradient another size in each run, and a few such pixels outweigh
    the rest."""
    cs = torch.stack([m.float() for m in maps])
    low = cs.amin(0)
    keep = (low > SILOG_EPS) & (cs.amax(0) - low <= rel * low)
    return torch.where(keep, depth, torch.zeros_like(depth)), 1.0 - float(keep.float().mean())


def kernels_against_plain(state, cfg, batch) -> None:
    """One loss + backward with the kernels (bf16) against the same with the
    plain versions routed in, beside the plain bf16 path against the plain
    fp32 one (the bf16 envelope), on the trained params: on every pixel, and
    on the pixels where the three runs' canonical maps agree within the
    gradient's bound (``conditioned_depth``). The gate applies to the
    latter; the former is printed for context."""
    images, depth = batch
    maps = []
    for precision, plain in TRAIN_RUNS.values():
        with routed(plain), torch.no_grad():
            c, _ = forward(state.params, images, cfg, precision, compute_fov=False)
        maps.append(c[..., 0].float())
    conditioned, left_out = conditioned_depth(depth, maps, TRAIN_GRAD_L2)
    del maps
    for target, gated in ((depth, False), (conditioned, True)):
        out = {}
        for name, (precision, plain) in TRAIN_RUNS.items():
            with routed(plain):
                loss, grads = value_and_grad(state.params, images, target, cfg, precision)
            out[name] = (float(loss), grads)
        (loss_k, grads_k), (loss_p, grads_p), (loss_f, grads_f) = out.values()
        l2, cos = grad_agreement(grads_k, grads_p)
        env_l2, env_cos = grad_agreement(grads_p, grads_f)
        del out, grads_k, grads_p, grads_f
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        pixels = (f"the {1 - left_out:.6f} of pixels where the runs' canonical maps agree within "
                  f"{TRAIN_GRAD_L2:g} ({left_out:.6f} left out)" if gated else "every pixel")
        log(f"[train] kernels against the plain versions, one loss + backward (large, bf16, batch "
            f"{BATCH}, the trained params, {pixels}): loss {loss_k:.6f} / {loss_p:.6f}, relative "
            f"difference {loss_rel:.3e} (bound {TRAIN_LOSS_BOUND:g}); gradient relative L2 "
            f"{l2:.3e} (bound {TRAIN_GRAD_L2:g}), cosine {cos:.6f} (bound {TRAIN_GRAD_COS:g})"
            f"{'' if gated else ', not gated'}; the plain bf16 path against plain fp32 (loss "
            f"{loss_f:.6f}): relative L2 {env_l2:.3e}, cosine {env_cos:.6f}; the forward's bf16 "
            f"envelope: {BF16_MAX_DEV:g} of scale")
        if gated and not (loss_rel <= TRAIN_LOSS_BOUND and l2 <= TRAIN_GRAD_L2
                          and cos >= TRAIN_GRAD_COS):
            raise AssertionError(f"train: kernels against plain: loss {loss_rel:.3e}, L2 "
                                 f"{l2:.3e}, cosine {cos:.6f}")


def tiny_case() -> tuple:
    """(cfg, images, depth, {device: params}) of the tiny fp32 step: random
    params from the seed through an npz, one batch of random images and
    depths, the params loaded onto the CPU and the card."""
    tree = map_tree(lambda t: t.numpy(),
                    init_depth_pro(tiny_config(), torch.Generator().manual_seed(SEED), "cpu"))
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    npz = TRAIN_DIR / "tiny.npz"
    save_params(str(npz), tree)
    cfg = dataclasses.replace(tiny_config(), checkpoint_uri=str(npz))
    rng = np.random.default_rng(SEED + 13)
    images = torch.from_numpy(
        rng.uniform(-1, 1, (BATCH, cfg.img_size, cfg.img_size, 3)).astype(np.float32))
    depth = torch.from_numpy(
        rng.uniform(1, 10, (BATCH, cfg.img_size, cfg.img_size)).astype(np.float32))
    return cfg, images, depth, {dev: load_checkpoint(cfg, dev) for dev in ("cpu", "cuda")}


def tiny_maps(cfg, images, params: dict) -> list:
    """The canonical inverse depth of the tiny fp32 forward on each device."""
    maps = []
    for dev, p in params.items():
        with torch.no_grad():
            c, _ = forward(p, images.to(dev), cfg, Precision.fp32(), compute_fov=False)
        maps.append(c[..., 0].cpu())
    return maps


def tiny_steps(cfg, images, depth, params: dict) -> dict:
    """{device: (loss, gradients on the CPU, the step's loss, launches)} of
    one fp32 ``value_and_grad`` and one ``train_step`` on each device."""
    out = {}
    for dev, p in params.items():
        state, step = make_train_step(p, cfg, dev, precision=Precision.fp32())
        x, d = images.to(dev), depth.to(dev)
        reset_launches()
        loss, grads = value_and_grad(state.params, x, d, cfg, Precision.fp32())
        launches = read_launches()
        state, step_loss = step(state, x, d)
        out[dev] = (float(loss), [None if g is None else g.cpu() for g in grads],
                    float(step_loss), launches)
    return out


def tiny_card_against_cpu() -> None:
    """One fp32 ``train_step`` of ``tiny_config()`` on the same npz and batch,
    the card (K1 at hd 32) against the CPU: loss and every gradient leaf, on
    the pixels where the two devices' canonical maps agree within
    ``TINY_CONDITIONING`` (``conditioned_depth``)."""
    cfg, images, depth, params = tiny_case()
    depth, left_out = conditioned_depth(depth, tiny_maps(cfg, images, params), TINY_CONDITIONING)
    out = tiny_steps(cfg, images, depth, params)
    (lc, gc, sc, _), (lg, gg, sg, launches) = out["cpu"], out["cuda"]
    if launches["K1"] != 2 * 2 * tiny_config().vit.depth:
        raise AssertionError(f"train tiny: the card's step launched {launches}")
    torch.testing.assert_close(lg, lc, rtol=TINY_LOSS_RTOL, atol=0)
    torch.testing.assert_close(sg, sc, rtol=TINY_LOSS_RTOL, atol=0)
    worst = 0.0
    for a, b in zip(gg, gc):
        if (a is None) != (b is None):
            raise AssertionError("train tiny: the devices' gradients reach different leaves")
        if a is not None:
            torch.testing.assert_close(a, b, rtol=TINY_GRAD_RTOL, atol=TINY_GRAD_ATOL)
            worst = max(worst, float((a - b).abs().max()))
    log(f"[train] tiny fp32 step, card (launches {launches}) against the CPU, raw params, "
        f"{left_out:.6f} of pixels left out as ill-conditioned (conditioning "
        f"{TINY_CONDITIONING:g}): loss {lg:.7f} / {lc:.7f} (rtol {TINY_LOSS_RTOL:g}), every "
        f"gradient leaf within rtol {TINY_GRAD_RTOL:g} / atol {TINY_GRAD_ATOL:g} (max |diff| "
        f"{worst:.3e}); the step's losses {sg:.7f} / {sc:.7f}")


def phase_train() -> dict:
    """``fit`` at the large preset (bf16, 1536^2, batch 2) on 8 written pairs:
    4 steps with checkpoints every 2, a restore checked bit for bit, a resumed
    ``fit`` that continues to step 8; then the step split, the kernels against
    the plain versions, and the tiny fp32 step on the card against the CPU."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    data, ckpt, metrics = TRAIN_DIR / "data", TRAIN_DIR / "ckpt", TRAIN_DIR / "metrics.jsonl"
    t0 = time.perf_counter()
    write_dataset(str(data), TRAIN_PAIRS, seed=SEED, size=512)
    log(f"[train] {TRAIN_PAIRS} pairs of 512^2 written by write_dataset in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = model_preset("large")
    kwargs = dict(cfg=cfg, batch_size=BATCH, lr=1e-4, warmup_steps=1, checkpoint_dir=str(ckpt),
                  save_every=2, log_every=1, metrics_file=str(metrics), seed=SEED, device="cuda")
    steps, saves = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with instrumented_fit(steps, saves):
        state = loop_module.fit(str(data), epochs=1, **kwargs)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = len(steps)
    want = {k: v * n for k, v in PER_TRAIN_STEP.items()}
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    log(f"[train] fit: large, bf16, 1536^2, batch {BATCH}, {n} steps: launches {launches} (want "
        f"{want}: {PER_TRAIN_STEP} per step), per step {[st['launches'] for st in steps]}; "
        f"losses {losses}; s per step {[round(st['s'], 4) for st in steps]}; saves "
        f"{[(st, round(x, 3)) for st, x in saves]} (step, s); peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB) on {card()}")
    if n != TRAIN_PAIRS // BATCH or state.step != n or launches != want or any(
            st["launches"] != PER_TRAIN_STEP for st in steps):
        raise AssertionError(f"train: {n} steps to step {state.step}, launches {launches}")
    if len(losses) != n or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: metrics losses {losses}")
    after_first = statistics.mean(st["s"] for st in steps[1:])
    log(f"[train] {after_first:.4f} s/step after the first step ({BATCH / after_first:.3f} "
        f"samples/s; first step {steps[0]['s']:.3f} s)")

    # the checkpoint: its bytes, a restore onto the card equal to the state bit for bit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = restore_train_state(str(ckpt), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = restored is not None and states_equal(TrainState.from_dict(restored), state)
    save_s = next(x for st, x in saves if st == n)
    log(f"[train] checkpoint of step {n}: {state_bytes(ckpt, n)} bytes, saved in "
        f"{save_s:.3f} s, restored in {load_s:.3f} s, equal to the trained state bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("train: the restored state differs from the saved one")
    del restored, state
    shutil.rmtree(ckpt / "2")  # the root filesystem holds ~79 GB; each state is ~11.4 GB

    # the resumed fit continues from step 4 to step 8 (2 epochs)
    steps2, saves2 = [], []
    reset_launches()
    with instrumented_fit(steps2, saves2):
        resumed = loop_module.fit(str(data), epochs=2, **kwargs)
    torch.cuda.synchronize()
    launches2 = read_launches()
    log(f"[train] resumed fit: continued to step {resumed.step} in {len(steps2)} steps, "
        f"launches {launches2}, s per step {[round(st['s'], 4) for st in steps2]}")
    if resumed.step != 2 * n or len(steps2) != n:
        raise AssertionError(f"train: the resumed fit ended at step {resumed.step}")
    shutil.rmtree(ckpt)
    total = {k: launches[k] + launches2[k] for k in launches}
    torch.cuda.empty_cache()

    batch = next(DepthDataset(str(data), cfg.img_size, seed=SEED).batches(BATCH, device="cuda"))
    split = split_step(resumed, cfg, batch)
    log(f"[train] one step split (CUDA events, large, bf16, batch {BATCH}): forward "
        f"{split['forward_ms']:.3f} ms, backward {split['backward_ms']:.3f} ms, optimizer "
        f"{split['optimizer_ms']:.3f} ms")
    kernels_against_plain(resumed, cfg, batch)
    del resumed, batch
    torch.cuda.empty_cache()
    tiny_card_against_cpu()
    return total


def phase_distill() -> dict:
    """``distill`` with a large teacher runner over 4 frames of 512^2, then
    the small student's ``fit`` for 2 steps."""
    from PIL import Image

    frames, labels = TRAIN_DIR / "frames", TRAIN_DIR / "labels"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 14)
    for i in range(DISTILL_FRAMES):
        Image.fromarray(FAMILIES["boxes"](rng, 512)[0]).save(frames / f"frame_{i:04d}.png")
    teacher = DepthVideoRunner(cfg=model_preset("large"), precision="bf16", batch_size=BATCH,
                               rng_seed=SEED, decode_pool="thread", device="cuda")
    steps, saves = [], []
    reset_launches()
    with instrumented_fit(steps, saves):
        state = distill_module.distill(str(frames), str(labels), student="small",
                                       teacher_runner=teacher, batch_size=BATCH, epochs=1,
                                       lr=1e-4, warmup_steps=0, log_every=1, seed=SEED,
                                       device="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    written = sorted(p.name for p in labels.glob("*_depth.npz"))
    teacher_forwards = math.ceil(DISTILL_FRAMES / BATCH)
    want = {k: PER_FORWARD["exact"][k] * teacher_forwards + PER_STUDENT_STEP[k] * len(steps)
            for k in launches}
    log(f"[distill] {len(written)} labels written by the large teacher ({teacher_forwards} "
        f"forwards), the small student (ViT-S, 6 heads x 64) trained {len(steps)} steps: "
        f"launches {launches} (want {want}), per student step {[st['launches'] for st in steps]}, "
        f"s per step {[round(st['s'], 4) for st in steps]} on {card()}")
    with np.load(labels / written[0]) as f:
        # random weights: the teacher's FOV head gives a finite f_px of either sign
        ok = f["depth"].shape == (512, 512) and np.isfinite(f["depth"]).all() and \
            math.isfinite(float(f["focallength_px"]))
    if (len(written) != DISTILL_FRAMES or not ok or len(steps) != DISTILL_FRAMES // BATCH
            or launches != want or any(st["launches"] != PER_STUDENT_STEP for st in steps)):
        raise AssertionError(f"distill: {len(written)} labels, {len(steps)} steps, launches "
                             f"{launches}")
    if not all(torch.isfinite(t).all() for t in tree_leaves(state.params)):
        raise AssertionError("distill: non-finite student params")
    del teacher, state
    shutil.rmtree(TRAIN_DIR)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# parallel: two ranks on the one card (parallel/, torch.distributed over gloo)


def latency_shapes(cfg: DepthProConfig, n_ranks: int, batch: int = 1) -> dict:
    """{"kernel rows x tokens x width": launches} of one latency forward on
    each rank: the patch ViT on the rank's slice of the padded patch axis (K1
    before the merge, K3 after it at the speed tiers), the image and FOV ViTs
    on the whole batch."""
    _, per = patch_split(35 * batch, n_ranks)
    v = cfg.vit
    width, full = 3 * v.embed_dim, v.num_tokens

    def key(kernel, rows, tokens):
        return f"{kernel} {rows}x{tokens}x{width}"

    out = {key("K1", per, full): v.depth}
    merge = min(cfg.token_merge_block, v.depth)
    if cfg.token_merge_ratio > 0.0 and merge < v.depth:
        kept = full - min(int(cfg.token_merge_ratio * (full - 1)), (full - 1) // 2)
        out = {key("K1", per, full): merge, key("K3", per, kept): v.depth - merge}
    out[key("K1", batch, full)] = 2 * v.depth
    return out


def band_rows(cfg: DepthProConfig, n_ranks: int) -> list:
    """Each rank's rows at each decoder level (``LEVELS``) in latency mode."""
    grid = cfg.vit.grid_size
    sizes = [grid // n_ranks + (1 if i < grid % n_ranks else 0) for i in range(n_ranks)]
    return [[k * s for k in LEVELS] for s in sizes]


def k2_band_shapes(cfg: DepthProConfig, n_ranks: int, rank: int, batch: int = 1) -> list:
    """The shapes K2 takes on ``rank`` in latency mode, in the decoder's order:
    the residual blocks of the levels no wider than ``FUSED_MAX_WIDTH`` (the
    width gate keeps the rest plain; the coarsest level has one block, the
    others two), each on the band plus two halo rows from every neighbour."""
    rows = band_rows(cfg, n_ranks)[rank]
    halo = 2 * ((rank > 0) + (rank < n_ranks - 1))
    grid = cfg.vit.grid_size
    return [(batch, rows[i] + halo, k * grid, cfg.decoder_features)
            for i, k in enumerate(LEVELS) if k * grid <= FUSED_MAX_WIDTH
            for _ in range(1 if i == 0 else 2)]


def band_cuts(cfg: DepthProConfig, n_ranks: int, height: int) -> list:
    """The rows of a ``height``-row output where the latency bands meet: the
    bands split the canonical map in whole token-grid rows, and the runner
    resizes it to the frame."""
    grid = cfg.vit.grid_size
    sizes = [grid // n_ranks + (1 if i < grid % n_ranks else 0) for i in range(n_ranks)]
    return [height * float(c) / grid for c in np.cumsum(sizes)[:-1]]


def halo_window(cfg: DepthProConfig, height: int) -> float:
    """Output rows within reach of a band's edge: two rows of the coarsest
    decoder level (a residual block's halo there)."""
    return 2.0 * height / (LEVELS[0] * cfg.vit.grid_size)


def deviation(inv: np.ndarray, inv_ref: np.ndarray, cuts: list, window: float) -> dict:
    """Inverse depth maps ``inv`` (N, H, W) against ``inv_ref``, as a share of
    the reference's scale: median, p99 and max; where the max lies (its row
    and its rows from the nearest cut); and how the top 1% of pixels crowd
    the cuts: their share within ``window`` rows of a cut over the share of
    all pixels there (about 1 where the error does not care where bands
    meet)."""
    share = np.abs(inv - inv_ref) / np.abs(inv_ref).max()
    rows = np.arange(share.shape[1]) + 0.5
    dist = np.min(np.abs(rows[:, None] - np.asarray(cuts, np.float64)[None]), axis=1)
    near = dist <= window
    p99 = float(np.quantile(share, 0.99))
    top = share > p99
    n_top = int(top.sum())
    crowding = float(top[:, near].sum() / n_top / near.mean()) if n_top else 0.0
    row = int(np.unravel_index(share.argmax(), share.shape)[1])
    return {"median": float(np.median(share)), "p99": p99, "max": float(share.max()),
            "equal": bool(np.array_equal(inv, inv_ref)), "max_row": row,
            "max_from_cut": float(dist[row]), "crowding": crowding}


def canonical_maps(params: dict, cfg: DepthProConfig, x: torch.Tensor, mesh) -> dict:
    """The canonical inverse depth (H, W) of the one frame ``x`` (1, img,
    img, 3) through ``forward`` with the latency hooks over ``mesh``: "sound",
    then with the halo zeroed at each decoder level k in turn (the control)."""
    from ml_depth_pro_video_tpu_torch.parallel import latency

    precision, grid = Precision.bf16(), cfg.vit.grid_size
    patch_vit_fn = latency._sharded_patch_vit(mesh, cfg, precision)
    out = {}
    for key, bands in [("sound", latency.RowBands),
                       *((k, zero_halo_bands(k * grid)) for k in LEVELS)]:
        with torch.inference_mode():
            canonical, _ = forward(params, x, cfg, precision, compute_fov=False,
                                   patch_vit_fn=patch_vit_fn, rows=bands(grid, mesh))
        out[key] = canonical[0, ..., 0].float().cpu().numpy()
    return out


def zero_halo_bands(width: int):
    """``RowBands`` whose halo rows are zeros at the decoder level ``width``
    columns wide: a halo that never arrived, the control of the latency check."""
    from ml_depth_pro_video_tpu_torch.parallel.latency import RowBands

    class ZeroHalo(RowBands):
        def extend(self, x, n):
            y = super().extend(x, n)
            if x.shape[2] == width:
                y = y.clone()
                if self.above:
                    y[:, :n] = 0
                if self.below:
                    y[:, y.shape[1] - n:] = 0
            return y

    return ZeroHalo


def parallel_rank(rank: int, port: str, folder: Path) -> None:
    """One rank of the ``parallel`` phase: steps (a)-(e) in turn, each rank's
    measurements written to ``folder/rank<rank>.json`` for the parent to check.
    Every runner of the rank shares one param tree per model shape (random,
    from ``SEED``, as every rank's and the unsharded runners' are)."""
    from collections import Counter

    from ml_depth_pro_video_tpu_torch.ops import resblock as resblock_module
    from ml_depth_pro_video_tpu_torch.parallel import latency as latency_module
    from ml_depth_pro_video_tpu_torch.parallel import multihost as mh
    from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh
    from ml_depth_pro_video_tpu_torch.serve.server import FollowerServer
    from ml_depth_pro_video_tpu_torch.video import runner as runner_module

    dev, cuda = PARALLEL_DEVICE, PARALLEL_DEVICE == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    real_build, built = runner_module.build_params, {}

    def shared_build(cfg, device, rng_seed=0):
        key = (cfg.vit, cfg.decoder_features, cfg.dims_encoder, str(device), rng_seed)
        if key not in built:
            built[key] = real_build(cfg, device, rng_seed)
        return built[key]

    runner_module.build_params = shared_build
    cfg = model_preset(PARALLEL_MODEL)
    coord = ["--coordinator", f"127.0.0.1:{port}", "--num_processes", str(PARALLEL_RANKS),
             "--process_id", str(rank)]
    kw = dict(precision="bf16", rng_seed=SEED, decode_pool="thread", device=dev)
    res = {"rank": rank}
    paths = sorted(str(p) for p in (folder / "frames").glob("*.png"))

    def counted(fn):
        sync()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, read_launches(), time.perf_counter() - t0

    # (a) maps: the CLI over the frames, each rank writing its own rows' files
    maps_out = folder / "maps"
    _, launches, maps_s = counted(lambda: generate_depth_maps.main(
        [str(folder / "frames"), "-o", str(maps_out), "--model", PARALLEL_MODEL, "--batch_size",
         str(PARALLEL_BATCH), "--save_npz", "--colormap", "gray16", "--device", dev, *coord]))
    cluster = mh.cluster()
    res["backend"], res["reason"] = cluster.backend, cluster.reason
    res["maps"] = {"launches": launches, "s": maps_s,
                   "forwards": math.ceil(PARALLEL_FRAMES / PARALLEL_BATCH)}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mh.barrier()
    if mh.is_primary():
        # the unsharded runner at the per-rank batch (1) on the same frames
        plain = DepthVideoRunner(cfg=cfg, batch_size=PARALLEL_BATCH // PARALLEL_RANKS, **kw)
        diffs = []
        for r in plain.depth_stream(paths):
            with np.load(maps_out / f"{Path(r['key']).stem}_depth.npz") as z:
                diffs.append((np.array_equal(z["depth"], r["depth"]),
                              float(np.abs(z["depth"] - r["depth"]).max())))
        res["maps"].update(files=len(list(maps_out.glob("*_depth.npz"))),
                           equal=all(d[0] for d in diffs), max_diff=max(d[1] for d in diffs))
        del plain
    mh.barrier()

    # (b) latency: batch 1 split over the ranks, exact and fast, against the unsharded runner
    rng = np.random.default_rng(SEED + 21)
    frames = [rng.integers(0, 256, PARALLEL_SHAPE + (3,), dtype=np.uint8)
              for _ in range(LATENCY_FRAMES)]
    real_attn, real_fused = vit_module.attention_packed, resblock_module.fused_residual_block
    real_comm = {"all_gather": mh.all_gather, "exchange": mh.exchange}
    for speed in ("exact", "fast"):
        shapes, k2 = Counter(), []
        comm = {name: [0, 0.0] for name in real_comm}

        def attn(qkv, heads, key_bias=None):
            shapes[f"{'K1' if key_bias is None else 'K3'} {'x'.join(map(str, qkv.shape))}"] += 1
            return real_attn(qkv, heads, key_bias)

        def fused(x, *args):
            k2.append(list(x.shape))
            return real_fused(x, *args)

        def synchronised(name):
            def fn(*args):
                sync()
                t0 = time.perf_counter()
                out = real_comm[name](*args)
                sync()
                comm[name][0] += 1
                comm[name][1] += time.perf_counter() - t0
                return out
            return fn

        runner = DepthVideoRunner(cfg=cfg, batch_size=1, speed=speed, mesh=make_mesh(),
                                  parallel="latency", **kw)
        vit_module.attention_packed, resblock_module.fused_residual_block = attn, fused
        for name in real_comm:
            setattr(mh, name, synchronised(name))
        try:
            got, launches, _ = counted(lambda: list(runner.depth_stream(frames[:2])))
        finally:
            vit_module.attention_packed, resblock_module.fused_residual_block = real_attn, real_fused
            for name, fn in real_comm.items():
                setattr(mh, name, fn)
        entry = {"launches": launches, "forwards": 2, "shapes": dict(shapes), "k2": k2}
        for name, (calls, secs) in comm.items():
            entry[f"{name} per forward"], entry[f"{name} ms per forward"] = calls / 2, 500 * secs
        if speed == "exact":
            list(runner.depth_stream(frames[:1]))
            _, _, secs = counted(lambda: list(runner.depth_stream(frames)))
            entry["ms_per_frame"] = 1000 * secs / len(frames)
            # one frame at the model's size through forward, its canonical inverse depth
            # unclamped: sound, and with the halo zeroed at each decoder level (the control)
            size = cfg.img_size
            square = torch.from_numpy(rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8))
            x = square.to(dev).float() / 127.5 - 1.0
            canonical = canonical_maps(runner.params, cfg, x, latency_module.make_sp_mesh())
        mh.barrier()
        if mh.is_primary():
            plain = DepthVideoRunner(cfg=cfg, batch_size=1, speed=speed, **kw)
            ref = list(plain.depth_stream(frames[:2]))
            inv = np.stack([1.0 / g["depth"] for g in got])
            inv_ref = np.stack([1.0 / r["depth"] for r in ref])
            entry.update(deviation(inv, inv_ref, band_cuts(cfg, PARALLEL_RANKS, inv.shape[1]),
                                   halo_window(cfg, inv.shape[1])),
                         at_clamp=float(np.mean(inv_ref <= DEPTH_CLAMP_INV)),
                         f_diff=max(abs(g["focallength_px"] - r["focallength_px"])
                                    for g, r in zip(got, ref)))
            if speed == "exact":
                list(plain.depth_stream(frames[:1]))
                _, _, secs = counted(lambda: list(plain.depth_stream(frames)))
                entry["plain_ms_per_frame"] = 1000 * secs / len(frames)
                with torch.inference_mode():
                    want, _ = forward(plain.params, x, cfg, Precision.bf16(), compute_fov=False)
                want = want[0, ..., 0].float().cpu().numpy()[None]
                cuts, window = band_cuts(cfg, PARALLEL_RANKS, size), halo_window(cfg, size)
                entry["canonical"] = {k: deviation(c[None], want, cuts, window)
                                      for k, c in canonical.items()}
            del plain
        res[f"latency {speed}"] = entry
        del runner
        mh.barrier()

    # (c) video pipeline: the CLI over the same frames without ground.json
    plans = folder / "plans"
    _, launches, secs = counted(lambda: cli_pipeline.main(
        ["--frames_dir", str(folder / "video_frames"), "--output_dir", str(plans), "--model",
         PARALLEL_MODEL, "--batch_size", str(PARALLEL_BATCH), "--num_workers", "2",
         "--renderer", "fast", "--no_fit_shapes", "--device", dev, *coord]))
    # frame 0 alone for the ground fit, then every frame in batches
    res["pipeline"] = {"launches": launches, "s": secs,
                       "forwards": 1 + math.ceil(PARALLEL_FRAMES / PARALLEL_BATCH)}

    # (d) serve --parallel dp: rank 0 answers 4 requests, rank 1 follows its batches
    dp_runner = DepthVideoRunner(cfg=cfg, batch_size=SERVE_BATCH, mesh=make_mesh(), **kw)
    window = [frames[i % len(frames)] for i in range(DP_TIMED)]
    list(dp_runner.depth_stream(window[:2 * SERVE_BATCH]))
    _, _, secs = counted(lambda: list(dp_runner.depth_stream(window)))
    res["dp_fps"] = DP_TIMED / secs
    bodies = [Path(p).read_bytes() for p in paths[:SERVE_BATCH]]
    sync()
    reset_launches()
    server = create_server(port=0, runner=dp_runner, parallel="dp", max_batch=SERVE_BATCH,
                           max_wait_ms=200.0)
    if isinstance(server, FollowerServer):
        server.serve_forever()  # until rank 0's server closes
        batches, answers = server.batches, []
    else:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with ThreadPoolExecutor(SERVE_BATCH) as ex:
            answers = list(ex.map(lambda b: decode_npz(post_depth(url, b, "?return=npz")[2]),
                                  bodies))
        batches = server.batcher.metrics.batches
        server.shutdown()
        server.server_close()
        thread.join(60)
    sync()
    res["serve"] = {"launches": read_launches(), "forwards": batches}
    mh.barrier()
    if mh.is_primary():
        # the unsharded runner at the per-rank batch, on the server's canonical frames
        from PIL import Image

        plain = DepthVideoRunner(cfg=cfg, batch_size=SERVE_BATCH // PARALLEL_RANKS, **kw)
        images = [np.asarray(Image.open(p).convert("RGB")) for p in paths[:SERVE_BATCH]]
        size = cfg.img_size
        ref = list(plain.depth_stream([canonicalize(im, size) for im in images]))
        devs, same = [], True
        for (depth, payload), r, im in zip(answers, ref, images):
            want, f = restore(r["depth"], r["focallength_px"], *im.shape[:2], size)
            same &= bool(np.array_equal(depth, want)) and payload["focallength_px"] == f
            devs.append(float(np.abs(depth - want).max() / np.abs(want).max()))
        res["serve"].update(answers=len(answers), equal=same, max_dev=max(devs),
                            shape=list(answers[0][0].shape))
        del plain
    del dp_runner, server
    mh.barrier()

    # (e) export: the parent's --dp 2 artifact served by a 2-rank dp runner
    artifact = folder / "dp2.pt2"
    t0 = time.perf_counter()
    while not Path(str(artifact) + ".json").exists():
        if time.perf_counter() - t0 > PARALLEL_TIMEOUT:
            raise TimeoutError(f"no {artifact} from the parent")
        time.sleep(0.5)
    ecfg = PARALLEL_EXPORT
    served = DepthVideoRunner(cfg=ecfg, batch_size=PARALLEL_BATCH, mesh=make_mesh(),
                              exported_path=str(artifact), **kw)
    eager = DepthVideoRunner(cfg=ecfg, batch_size=PARALLEL_BATCH, mesh=make_mesh(), **kw)
    size = ecfg.img_size
    square = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(4)]
    got, launches, _ = counted(lambda: list(served.depth_stream(square)))
    ref = list(eager.depth_stream(square))
    res["export"] = {"launches": launches, "forwards": math.ceil(4 / PARALLEL_BATCH),
                     "calls": served.exported_calls,
                     "equal": all(np.array_equal(g["depth"], r["depth"])
                                  and g["focallength_px"] == r["focallength_px"]
                                  for g, r in zip(got, ref))}
    del served, eager
    res["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    (folder / f"rank{rank}.json").write_text(json.dumps(res))
    mh.barrier()


def halo_fault(d: dict) -> bool:
    """Whether a deviation (``deviation``) reads as a halo error (``HALO_FAULT``)."""
    return d["max"] > HALO_FAULT["max"] or d["crowding"] > HALO_FAULT["crowding"]


def describe_deviation(d: dict) -> str:
    return (f"(inverse depth, share of scale) median {d['median']:.3e} p99 {d['p99']:.3e} max "
            f"{d['max']:.3e}, equal {d['equal']}; the max at row {d['max_row']}, "
            f"{d['max_from_cut']:.1f} rows from where the bands meet; the top 1% of pixels "
            f"{d['crowding']:.2f}x as dense near the cuts as elsewhere")


def check_parallel(res: list, exact_fps: float, export_s: float, wall: float) -> dict:
    """The parent's checks and lines of the ``parallel`` phase from the ranks'
    results; returns the launches of both ranks' main-path runs."""
    cfg, n = model_preset(PARALLEL_MODEL), PARALLEL_RANKS
    log(f"[parallel] {n} ranks on one card, tensor collectives on {res[0]['backend']} "
        f"({res[0]['reason']})")
    total = {name: 0 for name in KERNELS}

    def per_forward(step, want, tag):
        for r in res:
            got, fwd = r[step]["launches"], r[step]["forwards"]
            total.update({k: total[k] + got[k] for k in KERNELS})
            if got != {k: v * fwd for k, v in want.items()}:
                raise AssertionError(f"parallel {tag}: rank {r['rank']} launched {got} in {fwd} "
                                     f"forwards, want {want} per forward")
        return f"{want} per rank per forward ({res[0][step]['forwards']} forwards per rank)"

    maps = res[0]["maps"]
    line = per_forward("maps", PER_FORWARD["exact"], "maps")
    log(f"[parallel] (a) depth-pro-maps-torch --num_processes {n}: {PARALLEL_FRAMES} frames of "
        f"{PARALLEL_SHAPE[0]}x{PARALLEL_SHAPE[1]}, {PARALLEL_MODEL}, bf16, exact, batch "
        f"{PARALLEL_BATCH}: "
        f"{maps['files']} npz files, launches {line}; against the unsharded runner at the "
        f"per-rank batch: equal bit for bit {maps['equal']} (max |diff| {maps['max_diff']:.3e} m)")
    if maps["files"] != PARALLEL_FRAMES or not maps["equal"]:
        raise AssertionError(f"parallel maps: {maps}")

    for speed in ("exact", "fast"):
        e = res[0][f"latency {speed}"]
        line = per_forward(f"latency {speed}", PER_FORWARD[speed], f"latency {speed}")
        want = latency_shapes(apply_speed(cfg, speed) if speed != "exact" else cfg, n)
        for r in res:
            got = r[f"latency {speed}"]
            forwards = got["forwards"]
            if got["shapes"] != {k: v * forwards for k, v in want.items()}:
                raise AssertionError(f"parallel latency {speed}: rank {r['rank']} attention "
                                     f"shapes {got['shapes']}, want {want} per forward")
            if got["k2"] != [list(s) for s in k2_band_shapes(cfg, n, r["rank"])] * forwards:
                raise AssertionError(f"parallel latency {speed}: rank {r['rank']} K2 shapes "
                                     f"{got['k2']}")
        log(f"[parallel] (b) latency {speed}, batch 1: launches {line}; attention per rank per "
            f"forward {want}; K2 on the bands plus halo {[k2_band_shapes(cfg, n, r) for r in range(n)]} "
            f"(rows per rank per level {band_rows(cfg, n)}); per forward "
            f"{e['all_gather per forward']:.0f} gathers, {e['all_gather ms per forward']:.3f} ms, "
            f"and {e['exchange per forward']:.0f} halo exchanges, "
            f"{e['exchange ms per forward']:.3f} ms (rank 0, synchronised); "
            f"against the unsharded runner {describe_deviation(e)}, |f_px diff| {e['f_diff']:.3e}; "
            f"{e['at_clamp']:.4f} of the reference's pixels at the 1e4 m clamp")
        canonical = e.get("canonical", {})
        if speed == "exact" and set(canonical) != {"sound", *map(str, LEVELS)}:
            raise AssertionError(f"parallel latency exact: canonical maps {sorted(canonical)}")
        for k, c in canonical.items():
            what = ("sound" if k == "sound" else
                    f"control, the halo zeroed at the level {k} token grids high")
            log(f"[parallel] (b) canonical inverse depth of one {cfg.img_size}^2 frame through "
                f"forward, {what}, against the unsharded forward: {describe_deviation(c)}; "
                f"a halo error {halo_fault(c)} (max above {HALO_FAULT['max']:g} or crowding above "
                f"{HALO_FAULT['crowding']:g})")
            if halo_fault(c) != (k != "sound"):
                raise AssertionError(f"parallel latency {speed}: the canonical map, {what}, "
                                     f"reads as a halo error {halo_fault(c)}: {c}")
        if (e["p99"] > LATENCY_ENVELOPE["p99"] or e["max"] > LATENCY_ENVELOPE["max"]
                or e["crowding"] > HALO_FAULT["crowding"]):
            raise AssertionError(f"parallel latency {speed}: outside the bf16 envelope or "
                                 f"crowding the band cut: {e}")
    e = res[0]["latency exact"]
    log(f"[parallel] latency mode {e['ms_per_frame']:.3f} ms per frame over {n} ranks against the "
        f"unsharded runner's {e['plain_ms_per_frame']:.3f} ms (batch 1, {LATENCY_FRAMES} frames of "
        f"{PARALLEL_SHAPE[0]}x{PARALLEL_SHAPE[1]}, after a warm-up frame) on {card()}; both ranks "
        "share the card's SMs, so this is the machinery's overhead, not a speedup")

    pipe = res[0]["pipeline"]
    line = per_forward("pipeline", PER_FORWARD["exact"], "pipeline")
    plans = PARALLEL_DIR / "plans"
    done = [set(json.loads((plans / f"processing_progress{s}.json").read_text()))
            for s in ["", *(f".p{r}" for r in range(1, n))]]
    names = {f"output_{i:06d}.png" for i in range(PARALLEL_FRAMES)}
    ground = json.loads((PARALLEL_DIR / "video_frames" / "ground.json").read_text())
    if (set().union(*done) != names or sum(map(len, done)) != len(names)
            or not all(math.isfinite(v) for v in [*ground["normal"], ground["d"]])):
        raise AssertionError(f"parallel pipeline: progress {done}, ground {ground}")
    for name in names:
        check_image(plans / name.replace(".png", "_clean_simple_view.png"), "parallel pipeline")
    log(f"[parallel] (c) depth-pro-video-torch --num_processes {n}: one ground.json (d "
        f"{ground['d']:.6g}), progress per rank {[len(d) for d in done]} (disjoint, every "
        f"frame), {len(names)} plans decode; launches {line}; {pipe['s']:.3f} s")

    serve = res[0]["serve"]
    line = per_forward("serve", PER_FORWARD["exact"], "serve")
    log(f"[parallel] (d) create_server(parallel='dp') over {n} ranks: {serve['answers']} "
        f"requests answered by rank 0 ({serve['shape']}), {serve['forwards']} batches; launches "
        f"{line}; against the unsharded runner at the per-rank batch on the canonical frames: "
        f"equal bit for bit {serve['equal']}, max |diff| {serve['max_dev']:.3e} of scale (bound "
        f"{SERVE_REF_BOUND:g})")
    if serve["answers"] != SERVE_BATCH or serve["max_dev"] > SERVE_REF_BOUND:
        raise AssertionError(f"parallel serve: {serve}")

    exp = res[0]["export"]
    line = per_forward("export", PARALLEL_EXPORT_PER_FORWARD, "export")
    log(f"[parallel] (e) a --dp {n} artifact ({PARALLEL_EXPORT.vit.depth} blocks at width "
        f"{PARALLEL_EXPORT.vit.embed_dim}, exact, batch "
        f"{PARALLEL_BATCH}: {PARALLEL_BATCH // n} frame per rank; exported in {export_s:.3f} s "
        f"while the ranks ran) served by a {n}-rank dp runner: {exp['calls']} of "
        f"{exp['forwards']} forwards through it on every rank, launches {line}; equal to the "
        f"eager dp runner bit for bit {exp['equal']}")
    if not all(r["export"]["equal"] and r["export"]["calls"] == r["export"]["forwards"]
               for r in res):
        raise AssertionError(f"parallel export: {[r['export'] for r in res]}")
    log(f"[parallel] dp {res[0]['dp_fps']} frames/s over {DP_TIMED} frames of "
        f"{PARALLEL_SHAPE[0]}x{PARALLEL_SHAPE[1]} (batch {SERVE_BATCH}: {SERVE_BATCH // n} per "
        f"rank) against the exact slice's {exact_fps} (one rank, batch {BATCH}); peak memory per "
        f"rank {[r['peak_bytes'] for r in res]} bytes; the phase took {wall:.1f} s; on {card()}; "
        "both ranks share the card's SMs: the overhead of the parallel machinery, not a speedup")
    return total


def phase_parallel(exact_fps: float) -> dict:
    """Two ranks on the one card (gloo), each running ``parallel_rank``: the
    maps CLI, latency exact and fast, the pipeline CLI, the dp server and a
    ``--dp 2`` artifact, which this process exports while they run."""
    from PIL import Image

    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    frames = PARALLEL_DIR / "frames"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 7)  # the pipeline phase's frames
    for i in range(PARALLEL_FRAMES):
        Image.fromarray(rng.integers(0, 256, PARALLEL_SHAPE + (3,), dtype=np.uint8)).save(
            frames / f"output_{i:06d}.png")
    shutil.copytree(frames, PARALLEL_DIR / "video_frames")
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    logs = [open(PARALLEL_DIR / f"rank{r}.log", "w") for r in range(PARALLEL_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
                               str(r), port, str(PARALLEL_DIR)], stdout=log,
                              stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent))
             for r, log in enumerate(logs)]
    try:
        t1 = time.perf_counter()
        export_infer(PARALLEL_EXPORT, "bf16", PARALLEL_BATCH, str(PARALLEL_DIR / "dp2.pt2"),
                     device=PARALLEL_DEVICE, dp=PARALLEL_RANKS)
        export_s = time.perf_counter() - t1
        rcs = [p.wait(timeout=PARALLEL_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log_file in logs:
            log_file.close()
    wall = time.perf_counter() - t0
    if any(rcs):
        for r in range(PARALLEL_RANKS):
            tail = (PARALLEL_DIR / f"rank{r}.log").read_text().splitlines()[-40:]
            log(f"[parallel] rank {r} exited {rcs[r]}:\n" + "\n".join(tail))
        raise AssertionError(f"parallel: the ranks exited {rcs}")
    res = [json.loads((PARALLEL_DIR / f"rank{r}.json").read_text())
           for r in range(PARALLEL_RANKS)]
    total = check_parallel(res, exact_fps, export_s, wall)
    shutil.rmtree(PARALLEL_DIR)
    return total


# ---------------------------------------------------------------------------
# train_parallel: one training step across two ranks on the one card (dp, tp, pp)


def train_parallel_rows(layout, n: int) -> slice:
    """This rank's rows of an ``n``-row global batch under ``layout``."""
    from ml_depth_pro_video_tpu_torch.parallel import multihost as mh
    from ml_depth_pro_video_tpu_torch.parallel.mesh import batch_sharding

    rows = mh.local_rows(batch_sharding(layout.mesh), (n,))
    return slice(rows[0], rows[-1] + 1)


def parallel_canonical(state, images, cfg) -> torch.Tensor:
    """The canonical inverse depth of the whole batch through a step's sharded
    params (no grad): tp and pp run their collectives, dp gathers the rows."""
    from ml_depth_pro_video_tpu_torch.parallel.spmd import gather_rows
    from ml_depth_pro_video_tpu_torch.train.step import canonical_map

    lay = state.layout
    rows = train_parallel_rows(lay, images.shape[0])
    c = canonical_map(state.params, images[rows], cfg, Precision.bf16(), lay)
    return gather_rows(c, lay.mesh) if rows.stop - rows.start < images.shape[0] else c


def leaf_names(tree) -> list:
    """The "/"-joined path of every leaf, in ``tree_leaves`` order."""
    names: list = []
    _map_with_path(lambda path, _: names.append("/".join(path)), tree)
    return names


def split_leaf_l2(got: list, ref: list, specs: list, names: list) -> tuple:
    """(the worst relative L2 distance over the leaves a layout splits, that
    leaf's name): each split leaf held by its own norm, which the whole
    gradient's comparator cannot see (the ViT blocks' LayerScale of 1e-5 puts
    a vanishing share of the gradient there). (0.0, None) when nothing is
    split."""
    worst, name = 0.0, None
    for g, r, spec, n in zip(got, ref, specs, names):
        if spec and g is not None:
            rel = float(torch.linalg.vector_norm((g - r).double())
                        / torch.linalg.vector_norm(r.double()))
            if rel >= worst:
                worst, name = rel, n
    return worst, name


def train_parallel_fit(folder: Path, cfg, dp: int | None) -> dict:
    """``fit`` (``train/loop.py``) as a user calls it, 2 steps of the global
    batch with a holdout, a metrics file and a checkpoint at the end: over
    the group with ``dp``, else on one rank; the params it builds from the
    seed have the head bias raised as the steps' have. Returns the metrics,
    the steps' seconds and launches, and the seconds of the save."""
    tag = "fit_dp" if dp else "fit_one"
    steps, saves = [], []
    metrics = folder / f"{tag}.jsonl"
    real_build = loop_module.build_params

    def build(*args, **kwargs):
        # the final head bias raised by 0.5, as for the steps above: from the random init the
        # head sits at its ReLU 0, where the loss's 1/c gradient is ill-conditioned
        params = real_build(*args, **kwargs)
        params["head"]["conv_out"]["b"] += 0.5
        return params

    loop_module.build_params = build
    try:
        with instrumented_fit(steps, saves):
            state = loop_module.fit(str(folder / "data"), cfg, dp=dp, metrics_file=str(metrics),
                                    checkpoint_dir=str(folder / tag) if dp else None,
                                    device="cuda", **TRAIN_PARALLEL_FIT)
    finally:
        loop_module.build_params = real_build
    out = {"steps": steps, "saves": saves, "state": state}
    if metrics.exists():  # written by rank 0
        out["metrics"] = [json.loads(line) for line in metrics.read_text().splitlines()]
    return out


def train_parallel_rank(rank: int, port: str, folder: Path) -> None:
    """One rank of the ``train_parallel`` phase: the canonical maps of the
    one-rank forward and of each mode, the conditioned target, the one-rank
    step's loss and gradients (rank 0, the other rank waiting), then one step
    of each mode through the step ``make_train_step`` returns, on the same
    global batch: its gradients (taken where the step hands them to AdamW)
    gathered and held against the one-rank step's, its clipped update held
    against the one-rank AdamW on those gradients, a tp=2 checkpoint written
    once and restored; then ``fit`` over the 2 ranks (dp=2), its checkpoint
    restored. Results go to ``folder/rank<rank>.json``."""
    from collections import Counter

    from ml_depth_pro_video_tpu_torch.ckpt.checkpointing import save_train_state
    from ml_depth_pro_video_tpu_torch.parallel import multihost as mh
    from ml_depth_pro_video_tpu_torch.parallel.sharding import gather_leaf, gather_params

    mh.initialize(f"127.0.0.1:{port}", TRAIN_PARALLEL_RANKS, rank, device="cuda")
    cfg = model_preset("large")
    params = build_params(cfg, "cuda", SEED)
    # the final head bias raised by 0.5, as the train phase's comparison does: at random init
    # most pixels sit at the head's ReLU 0, where the loss's 1/c gradient is ill-conditioned
    params["head"]["conv_out"]["b"] += 0.5
    names = leaf_names(params)
    images, depth = next(DepthDataset(str(folder / "data"), cfg.img_size, seed=SEED).batches(
        BATCH, device="cuda"))
    res = {"rank": rank, "backend": mh.cluster().backend, "reason": mh.cluster().reason}
    # K1's shapes, through the name the ViT looks up; the collectives' host time, synchronised
    shapes, real_attn = Counter(), vit_module.attention_packed

    def attn(qkv, heads, key_bias=None):
        shapes[f"K1 {'x'.join(map(str, qkv.shape))}"] += 1
        return real_attn(qkv, heads, key_bias)

    comm, counting = {}, [True]  # counting off: a gather made only for a comparison

    def timed_comm(name, fn):
        def run(*args, **kwargs):
            if not counting[0]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            c = comm.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    vit_module.attention_packed = attn
    for name in ("all_reduce", "all_gather", "transfer", "broadcast"):
        setattr(mh, name, timed_comm(name, getattr(mh, name)))

    # (1) every run's canonical map, for the pixels the comparator keeps
    t0 = time.perf_counter()
    maps = []
    with torch.no_grad():
        maps.append(forward(params, images, cfg, Precision.bf16(), compute_fov=False)[0][..., 0]
                    .float())
        for kw in TRAIN_PARALLEL_MODES.values():
            state, _ = make_train_step(params, cfg, "cuda", precision=Precision.bf16(), **kw)
            maps.append(parallel_canonical(state, images, cfg))
            del state
    target, left_out = conditioned_depth(depth, maps, TRAIN_GRAD_L2)
    target = mh.broadcast(target, 0)  # rank 0's, exactly
    res["left_out"], res["maps_s"] = left_out, time.perf_counter() - t0
    del maps

    # (2) the one-rank step's loss and gradients on rank 0, freed before the modes run
    ref = None
    if rank == 0:
        one = map_tree(lambda t: t.detach().clone().requires_grad_(), params)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(one, images, target, cfg, Precision.bf16())
        torch.cuda.synchronize()
        res["one_rank"] = {"s": time.perf_counter() - t0, "loss": float(loss),
                           "peak_bytes": torch.cuda.max_memory_allocated()}
        ref = [None if g is None else g.float().cpu() for g in grads]
        del one, grads, loss
        torch.cuda.empty_cache()
    mh.barrier()

    # (3) one step of each mode on the same global batch, through the returned step
    for mode, kw in TRAIN_PARALLEL_MODES.items():
        state, step = make_train_step(params, cfg, "cuda", lr=1e-4, precision=Precision.bf16(),
                                      warmup_steps=0, **kw)
        lay, optimizer = state.layout, step.keywords["optimizer"]
        rows = train_parallel_rows(lay, BATCH)
        x, t = images[rows], target[rows]
        seen = {}

        def update(grads, opt_state, local, layout, real=optimizer.update):
            # where the step hands its gradients to AdamW: the gradients' time ends here; the
            # gather for the comparison is left out of both times
            torch.cuda.synchronize()
            seen["grad_end"] = time.perf_counter()
            seen["grad_peak"] = torch.cuda.max_memory_allocated()
            counting[0] = False
            seen["full"] = [None if g is None else gather_leaf(g, sp, layout.mesh).float().cpu()
                            for g, sp in zip(grads, layout.leaf_specs)]
            counting[0] = True
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()  # the gather's buffers are not the step's
            seen["opt_start"] = time.perf_counter()
            return real(grads, opt_state, local, layout)

        def global_norm(norms, idx, real=lay.global_norm):
            seen["norm"] = real(norms, idx)
            return seen["norm"]

        optimizer.update, lay.global_norm = update, global_norm
        shapes.clear()
        comm.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, x, t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = {"grad_s": seen["grad_end"] - t0, "optimizer_s": t1 - seen["opt_start"],
               "launches": read_launches(), "shapes": dict(shapes),
               "comm": {k: [n, ms] for k, (n, ms) in comm.items()}, "loss": float(loss),
               "norm": float(seen["norm"]),
               "peak_bytes": max(seen["grad_peak"], torch.cuda.max_memory_allocated())}
        out["s"] = out["grad_s"] + out["optimizer_s"]
        # the leaves every rank holds whole (every leaf under dp), params and both moments, equal
        # on every rank after the step: a gradient summed over too few ranks shows here even
        # where it hides in the comparators (AdamW's first update is near sign(g); mu is not)
        opt_state, leaves = state.opt_state, tree_leaves(state.params)
        whole_leaves = [i for i, sp in enumerate(lay.leaf_specs) if not sp]
        sums = torch.stack([t.detach().double().sum() for i in whole_leaves
                            for t in (leaves[i], opt_state.mu[i], opt_state.nu[i])])
        pieces = mh.all_gather(sums)
        out["replicated_equal"] = all(torch.equal(pieces[0], q) for q in pieces[1:])
        del leaves, opt_state  # or the next mode's peak counts these moments
        full = seen.pop("full")
        stepped = gather_params(map_tree(lambda p: p.detach(), state.params), lay.mesh,
                                specs=lay.specs, device="cpu")  # collective
        if rank == 0:
            out["l2"], out["cos"] = grad_agreement(full, ref)
            out["split_l2"], out["split_leaf"] = split_leaf_l2(full, ref, lay.leaf_specs, names)
            out["loss_rel"] = abs(out["loss"] - res["one_rank"]["loss"]) / abs(
                res["one_rank"]["loss"])
            # the one-rank AdamW (the same settings) on the gathered gradients, from the same params
            have = [g for g in full if g is not None]
            out["norm_rel"] = abs(out["norm"] / float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.double()) for g in have]))) - 1)
            one = map_tree(lambda p: p.detach().clone(), params)
            opt = make_optimizer(1e-4, warmup_steps=0)
            opt.update([None if g is None else g.cuda() for g in full], opt.init(one), one)
            diffs = [float((a - b.cpu()).abs().max())
                     for a, b in zip(tree_leaves(stepped), tree_leaves(one))]
            moved = [float((a - b).abs().max())
                     for a, b in zip(tree_leaves(one), tree_leaves(params))]
            out["update_diff"], out["update_moved"] = max(diffs), max(moved)
            del one, opt, have
        del full, stepped
        if mode == "tp":
            # one checkpoint in the one-rank layout, rank 0 writing; a restore re-cut for tp=2
            t0 = time.perf_counter()
            whole = state.to_dict()
            save_train_state(str(folder / "ckpt"), whole, 1)
            out["save_s"] = time.perf_counter() - t0
            if rank != 0:
                del whole
            t0 = time.perf_counter()
            restored = restore_train_state(str(folder / "ckpt"), device="cpu")
            out["restore_s"] = time.perf_counter() - t0
            if rank == 0:
                shapes_ok = [tuple(a.shape) for a in tree_leaves(restored["params"])] == [
                    tuple(a.shape) for a in tree_leaves(params)]
                out["one_rank_equal"] = shapes_ok and states_equal(
                    TrainState.from_dict(restored), TrainState.from_dict(whole))
                del whole
            out["shard_equal"] = states_equal(TrainState.from_dict(restored, lay, "cuda"), state)
            del restored
        res[mode] = out
        del state, step, optimizer, lay
        torch.cuda.empty_cache()
        mh.barrier()
    del params, ref
    torch.cuda.empty_cache()

    # (4) fit over the two ranks: dp=2, its checkpoint restored against the gathered state
    reset_launches()
    fit = train_parallel_fit(folder, cfg, dp=TRAIN_PARALLEL_RANKS)
    fit["launches"] = read_launches()
    whole = fit.pop("state").to_dict()  # collective
    if rank == 0:
        restored = restore_train_state(str(folder / "fit_dp"), device="cpu")
        fit["restored_equal"] = restored is not None and states_equal(
            TrainState.from_dict(restored), TrainState.from_dict(whole))
        del restored
    del whole
    res["fit"] = fit
    (folder / f"rank{rank}.json").write_text(json.dumps(res))
    mh.barrier()


def train_parallel_shapes(cfg: DepthProConfig, mode: str, batch: int = BATCH) -> dict:
    """{"K1 rows x tokens x width": launches} per rank per step of one mode:
    each ViT block's forward and its recompute in the backward, the FOV ViT
    off. dp: each rank's rows; tp: every row on half the heads; pp: the
    patch ViT's blocks of one stage per microbatch, the image ViT whole."""
    kw = TRAIN_PARALLEL_MODES[mode]
    vit, n = cfg.vit, TRAIN_PARALLEL_RANKS
    per = batch // kw.get("dp", 1)
    width = 3 * vit.embed_dim // kw.get("tp", 1)
    s = vit.num_tokens
    if "pp" in kw:
        m = kw["microbatches"]
        return {f"K1 {35 * per // m}x{s}x{width}": 2 * m * vit.depth // n,
                f"K1 {per}x{s}x{width}": 2 * vit.depth}
    return {f"K1 {35 * per}x{s}x{width}": 2 * vit.depth, f"K1 {per}x{s}x{width}": 2 * vit.depth}


def train_parallel_k5(cfg: DepthProConfig, mode: str) -> int:
    """K5 launches per rank per step of one mode: dp and tp as the one-rank
    step; pp: 3 for each of the stage's patch blocks per microbatch and 3
    again in the recompute, the final norm once on the banked output, the
    image ViT whole."""
    kw = TRAIN_PARALLEL_MODES[mode]
    if "pp" not in kw:
        return PER_TRAIN_STEP["K5"]
    depth = cfg.vit.depth
    blocks = kw["microbatches"] * depth // TRAIN_PARALLEL_RANKS
    return 6 * blocks + 1 + (3 * depth + 1) + 3 * depth


def check_train_parallel(res: list, one_fit: dict, wall: float) -> dict:
    """The parent's checks and lines of the ``train_parallel`` phase; returns
    both ranks' launches over the three steps and the 2-rank ``fit``."""
    cfg, n = model_preset("large"), TRAIN_PARALLEL_RANKS
    one = res[0]["one_rank"]
    log(f"[train_parallel] {n} ranks on one card, tensor collectives on {res[0]['backend']} "
        f"({res[0]['reason']}); large, bf16 on fp32 masters, {cfg.img_size}^2, global batch "
        f"{BATCH} of write_dataset pairs; the one-rank step on rank 0: loss {one['loss']:.6f}, "
        f"{one['s']:.3f} s (loss + gradients, peak {one['peak_bytes']} bytes); "
        f"{res[0]['left_out']:.6f} of pixels left out as ill-conditioned (the runs' canonical "
        f"maps apart by more than {TRAIN_GRAD_L2:g}; maps {res[0]['maps_s']:.1f} s)")
    total = {k: 0 for k in KERNELS}
    for mode in TRAIN_PARALLEL_MODES:
        want_shapes = train_parallel_shapes(cfg, mode)
        want = {"K1": sum(want_shapes.values()), "K2": 3, "K3": 0, "K4": 0,
                "K5": train_parallel_k5(cfg, mode)}
        for r in res:
            got = r[mode]
            total.update({k: total[k] + got["launches"][k] for k in KERNELS})
            if got["launches"] != want or got["shapes"] != want_shapes:
                raise AssertionError(f"train_parallel {mode}: rank {r['rank']} launched "
                                     f"{got['launches']} at {got['shapes']}, want {want} at "
                                     f"{want_shapes}")
        e = res[0][mode]
        comm = {k: f"{c[0]} calls {c[1]:.1f} ms" for k, c in e["comm"].items()}
        split = (f"worst split leaf {e['split_leaf']}: relative L2 {e['split_l2']:.3e} (bound "
                 f"{TRAIN_GRAD_L2:g})" if e["split_leaf"] else "no leaf split")
        log(f"[train_parallel] {mode} ({TRAIN_PARALLEL_MODES[mode]}): launches per rank per step "
            f"{want} ({want_shapes}); loss {e['loss']:.6f}, relative difference "
            f"{e['loss_rel']:.3e} (bound {TRAIN_LOSS_BOUND:g}); gradient against the one-rank "
            f"step's: relative L2 {e['l2']:.3e} (bound {TRAIN_GRAD_L2:g}), cosine "
            f"{e['cos']:.6f} (bound {TRAIN_GRAD_COS:g}), {split}; clipped AdamW (global norm "
            f"{e['norm']:.6g}, clip 1, {e['norm_rel']:.2e} from the gathered gradient's; bound "
            f"{TRAIN_NORM_REL:g}) against the one-rank AdamW on the gathered gradients: max |diff| "
            f"{e['update_diff']:.3e} (bound {TRAIN_UPDATE_BOUND:g}) where the update moved a "
            f"param by up to {e['update_moved']:.3e}; the whole leaves' params and moments equal on "
            f"every rank: {e['replicated_equal']}; {e['s']:.3f} s/step through the step "
            f"(gradients {e['grad_s']:.3f}, AdamW {e['optimizer_s']:.3f}; one step, the first "
            f"of its mode), rank 0's collectives {comm} (host time, synchronised); peak memory "
            f"per rank {[r[mode]['peak_bytes'] for r in res]} bytes; on {card()}")
        if not (e["loss_rel"] <= TRAIN_LOSS_BOUND and e["l2"] <= TRAIN_GRAD_L2
                and e["cos"] >= TRAIN_GRAD_COS and e["split_l2"] <= TRAIN_GRAD_L2
                and e["norm_rel"] <= TRAIN_NORM_REL and e["update_diff"] <= TRAIN_UPDATE_BOUND
                and e["update_moved"] > TRAIN_UPDATE_BOUND and e["replicated_equal"]):
            raise AssertionError(f"train_parallel {mode}: loss {e['loss_rel']:.3e}, L2 "
                                 f"{e['l2']:.3e}, cosine {e['cos']:.6f}, split leaf "
                                 f"{e['split_l2']:.3e}, norm {e['norm_rel']:.2e}, update "
                                 f"{e['update_diff']:.3e} of {e['update_moved']:.3e}, "
                                 f"whole leaves equal {e['replicated_equal']}")
    tp = res[0]["tp"]
    log(f"[train_parallel] the tp=2 checkpoint: gathered and saved once by rank 0 in "
        f"{tp['save_s']:.3f} s, restored in {tp['restore_s']:.3f} s; in the one-rank layout and "
        f"equal to the gathered state bit for bit: {tp['one_rank_equal']}; re-cut for tp=2 and "
        f"equal to each rank's state bit for bit: {[r['tp']['shard_equal'] for r in res]}")
    if not (tp["one_rank_equal"] and all(r["tp"]["shard_equal"] for r in res)):
        raise AssertionError("train_parallel: the tp=2 checkpoint did not restore bit for bit")
    # fit over the 2 ranks (dp=2) against fit on one rank, in fp32 (K2 and K5 are bf16 only):
    # per step, 96 K1 (each block's forward and its recompute); the validation's forward 48 K1
    fits = [r["fit"] for r in res]
    per_step = {"K1": 96, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    steps = (TRAIN_PARALLEL_PAIRS - TRAIN_PARALLEL_HOLDOUT) // BATCH
    want = {"K1": steps * 96 + 48, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    for f in fits + [one_fit]:
        if [s["launches"] for s in f["steps"]] != [per_step] * steps or f["launches"] != want:
            raise AssertionError(f"train_parallel fit: launched {f['launches']}, per step "
                                 f"{[s['launches'] for s in f['steps']]}, want {want}")
    for f in fits:
        total.update({k: total[k] + f["launches"][k] for k in KERNELS})
    got, ref = fits[0]["metrics"], one_fit["metrics"]
    losses = [(a.get("loss", a.get("val_silog")), b.get("loss", b.get("val_silog")))
              for a, b in zip(got, ref)]
    rel = max(abs(a - b) / abs(b) for a, b in losses)
    log(f"[train_parallel] fit over {n} ranks (dp=2, depth-pro-train-torch's fit in fp32: global batch "
        f"{BATCH}, {steps} steps, holdout {TRAIN_PARALLEL_HOLDOUT}, a checkpoint at the end) "
        f"against fit on one rank: losses then val_silog {[a for a, _ in losses]} / "
        f"{[b for _, b in losses]}, worst relative difference {rel:.3e} "
        f"(bound {TRAIN_LOSS_BOUND:g}); launches per rank {want} ({per_step} per step); s per "
        f"step {[round(s['s'], 4) for s in fits[0]['steps']]} / "
        f"{[round(s['s'], 4) for s in one_fit['steps']]}; the checkpoint gathered and saved by "
        f"rank 0 in {fits[0]['saves'][-1][1]:.3f} s, restored equal to the gathered state bit "
        f"for bit: {fits[0]['restored_equal']}")
    if not (len(got) == len(ref) == steps + 1 and [a["step"] for a in got] == [
            b["step"] for b in ref] and rel <= TRAIN_LOSS_BOUND and fits[0]["restored_equal"]):
        raise AssertionError(f"train_parallel fit: metrics {got} against {ref}, restored "
                             f"{fits[0]['restored_equal']}")
    log(f"[train_parallel] the phase took {wall:.1f} s; both ranks share the card's SMs and "
        "their collectives go through host memory (gloo): the machinery's cost, not a speedup")
    return total


def phase_train_parallel() -> dict:
    """``fit`` on one rank, then two ranks on the one card (gloo), each
    running ``train_parallel_rank``: one step of dp=2, tp=2 and pp=2 at the
    large preset, held against the one-rank step on the same global batch,
    and ``fit`` over both, held against the one-rank ``fit``."""
    shutil.rmtree(TRAIN_PARALLEL_DIR, ignore_errors=True)
    write_dataset(str(TRAIN_PARALLEL_DIR / "data"), TRAIN_PARALLEL_PAIRS, seed=SEED, size=512)
    reset_launches()
    one_fit = train_parallel_fit(TRAIN_PARALLEL_DIR, model_preset("large"), dp=None)
    one_fit["launches"] = read_launches()
    del one_fit["state"]
    gc.collect()
    torch.cuda.empty_cache()
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    logs = [open(TRAIN_PARALLEL_DIR / f"rank{r}.log", "w") for r in range(TRAIN_PARALLEL_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--train-parallel-rank", str(r), port, str(TRAIN_PARALLEL_DIR)],
                              stdout=log, stderr=subprocess.STDOUT,
                              cwd=str(Path(__file__).resolve().parent))
             for r, log in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=TRAIN_PARALLEL_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log_file in logs:
            log_file.close()
    wall = time.perf_counter() - t0
    if any(rcs):
        for r in range(TRAIN_PARALLEL_RANKS):
            tail = (TRAIN_PARALLEL_DIR / f"rank{r}.log").read_text().splitlines()[-40:]
            log(f"[train_parallel] rank {r} exited {rcs[r]}:\n" + "\n".join(tail))
        raise AssertionError(f"train_parallel: the ranks exited {rcs}")
    res = [json.loads((TRAIN_PARALLEL_DIR / f"rank{r}.json").read_text())
           for r in range(TRAIN_PARALLEL_RANKS)]
    total = check_train_parallel(res, one_fit, wall)
    shutil.rmtree(TRAIN_PARALLEL_DIR)
    return total


def main() -> int:
    t_start = time.perf_counter()
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
    paths["parallel"] = phase_parallel(exact_fps)
    gc.collect()  # the earlier phases' runners: training needs tens of GB of its own
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths["train_parallel"] = phase_train_parallel()
    log(f"[train_parallel] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    backward = plain_backward_ms()
    paths["train"] = phase_train()
    t1 = time.perf_counter()
    paths["distill"] = phase_distill()
    log(f"[train] the train phase took {t1 - t0:.1f} s, the distill phase "
        f"{time.perf_counter() - t1:.1f} s")
    kernels = []
    for key, k in KERNELS.items():
        by_path = {name: counts[key] for name, counts in paths.items()}
        extra = {"backward": backward[key]} if key in backward else {}
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **report[key], **extra})
    log(f"[done] {card()}; chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of the parallel phase, started by it
        sys.exit(parallel_rank(int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])))
    if sys.argv[1:2] == ["--train-parallel-rank"]:  # a rank of the train_parallel phase
        sys.exit(train_parallel_rank(int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])))
    sys.exit(main())
