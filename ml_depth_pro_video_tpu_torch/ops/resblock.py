"""Fused DPT residual block: out = x + conv3x3(relu(conv3x3(relu(x)))).

Twin of ``ml_depth_pro_video_tpu/ops/resblock.py::residual_block``. Both
convs are 3x3, pad 1; x is NHWC, weights HWIO (3, 3, C, C), biases (C,).

``residual_block_reference`` is the plain PyTorch composition. The port's
kernel K2 replaces the Pallas kernel ``_resblock_pallas``: at 256 channels
(the large preset's decoder) the wgmma + TMA body of
``csrc/resblock_wgmma.cu``, at other widths the mma.sync body of
``csrc/resblock.cu``, whose entry point dispatches (``k2_body`` says which
body and tile a shape takes). It is the custom operator ``depth_pro::resblock``
(``resblock_op``), so that a traced graph names it: the plain version for a
CPU tensor, K2 for a CUDA tensor, and a raise for any other device.
``residual_block`` routes like the JAX package: bf16 square-channel blocks
of at most 256 channels, a multiple of 8, at the decoder's small levels go
through ``fused_residual_block``; everything else (fp32 parity mode, the
192^2+ levels, channel counts K2 does not take) takes the plain composition. The width gate W <= 96 is the JAX
package's TPU v5e measurement, kept on the H100: there K2 is slower than
the plain composition at 192^2 and 384^2 (PERF.md, PR 5).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels.loader import Kernel, KernelLaunchError, load_library
from .attention import plain_vjp, save_inputs
from .conv import conv2d

K2 = Kernel(
    name="resblock",
    symbol="resblock_forward",
    source="ml_depth_pro_video_tpu_torch/csrc/resblock_wgmma.cu",  # C = 256: every model path
    replaces="ml_depth_pro_video_tpu/ops/resblock.py:129",
)
# csrc/resblock.cu::resblock_kernel_body's codes
K2_BODIES = {0: "mma.sync", 1: "wgmma"}

FUSED_MAX_WIDTH = 96
K2_MAX_CHANNELS = 256  # one pass of K2's 8 warps x 32 output channels


def residual_block_reference(x, w1, b1, w2, b2):
    h = conv2d(F.relu(x), w1, b1, padding=1)
    h = conv2d(F.relu(h), w2, b2, padding=1)
    return x + h


def k2_body(bsz: int, h: int, w: int, c: int, device: int = 0) -> tuple[str, tuple[int, int]]:
    """The body K2 takes for a (bsz, h, w, c) input on CUDA device ``device``
    (``"wgmma"`` at 256 channels, ``"mma.sync"`` else) and its output tile
    (rows, columns): a function of the shape alone."""
    body, th, tw = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = load_library().resblock_kernel_body(bsz, h, w, c, device, ctypes.byref(body),
                                              ctypes.byref(th), ctypes.byref(tw))
    if err:
        raise KernelLaunchError(f"resblock_kernel_body returned cudaError {err}")
    return K2_BODIES[body.value], (th.value, tw.value)


def _resblock_cuda(x, w1, b1, w2, b2):
    """Launch K2; raise on anything it does not take."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"resblock kernel takes bf16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"resblock kernel takes NHWC x, got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if w1.shape != (3, 3, c, c) or w2.shape != (3, 3, c, c):
        raise ValueError(f"resblock kernel needs (3, 3, {c}, {c}) weights, "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    if b1.shape != (c,) or b2.shape != (c,):
        raise ValueError(f"resblock kernel needs ({c},) biases, got {tuple(b1.shape)} and "
                         f"{tuple(b2.shape)}")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("resblock kernel needs x, weights and biases on one device")
    if c % 8 or c > K2_MAX_CHANNELS:
        raise ValueError(f"resblock kernel needs channels % 8 == 0 and <= {K2_MAX_CHANNELS}, "
                         f"got {c}")
    if x.numel() == 0:
        return x.clone()
    x = x.contiguous()
    # casts only: (3, 3, C, C) -> (9, C, C) is a view; the kernel rounds the
    # fp32 biases to bf16 itself, as the TPU kernel reads them
    ws = [t.to(torch.bfloat16).contiguous().view(9, c, c) for t in (w1, w2)]
    bs = [t.float().contiguous() for t in (b1, b2)]
    if x.data_ptr() % 16 or any(t.data_ptr() % 16 for t in ws) or any(
            t.data_ptr() % 8 for t in bs):
        raise ValueError("resblock kernel needs 16-byte aligned x and weights, 8-byte aligned "
                         "biases")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (x, ws[0], bs[0], ws[1], bs[1], out)]
    K2.launch(*ptr, bsz, h, w, c, x.device.index, ctypes.c_void_p(stream))
    return out


@torch.library.custom_op("depth_pro::resblock", mutates_args=(), device_types="cuda")
def resblock_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """K2 as an operator: its CUDA kernel launches K2, its CPU kernel is the
    plain composition, a tensor on any other device raises; the fake kernel
    gives tracing the output's shape, and backward recomputes through the
    plain composition (as the JAX custom VJP does)."""
    return _resblock_cuda(x, w1, b1, w2, b2)


@resblock_op.register_kernel("cpu")
def _(x, w1, b1, w2, b2):
    return residual_block_reference(x, w1, b1, w2, b2)


@resblock_op.register_fake
def _(x, w1, b1, w2, b2):
    return x.new_empty(x.shape)


def _backward(ctx, grad):
    return plain_vjp(residual_block_reference, ctx.saved_tensors, grad, ctx.needs_input_grad)


resblock_op.register_autograd(_backward, setup_context=save_inputs)


def fused_residual_block(x, w1, b1, w2, b2):
    """K2 on a CUDA tensor, the plain version on a CPU tensor."""
    return resblock_op(x, w1, b1, w2, b2)


def residual_block(x, w1, b1, w2, b2):
    """x + conv2(relu(conv1(relu(x)))), convs 3x3 pad 1."""
    c = w1.shape[2]
    if (x.dtype == torch.bfloat16 and c == w1.shape[3] == x.shape[-1]
            and c % 8 == 0 and c <= K2_MAX_CHANNELS and x.shape[2] <= FUSED_MAX_WIDTH):
        return fused_residual_block(x, w1, b1, w2, b2)
    return residual_block_reference(x, w1, b1, w2, b2)
