"""Fused DPT residual block: out = x + conv3x3(relu(conv3x3(relu(x)))).

Twin of ``ml_depth_pro_video_tpu/ops/resblock.py::residual_block``. Both
convs are 3x3, pad 1; x is NHWC, weights HWIO (3, 3, C, C), biases (C,).

``residual_block_reference`` is the plain PyTorch composition. The port's
kernel K2 (``csrc/resblock.cu``) replaces the Pallas kernel
``_resblock_pallas``; ``fused_residual_block`` takes the plain version for
a CPU tensor and launches K2 for a CUDA tensor, or raises.
``residual_block`` routes like the JAX package: bf16 square-channel blocks
at the decoder's small levels (W <= 96, a TPU v5e measurement not yet
re-tuned on the H100) go through ``fused_residual_block``; everything else
(fp32 parity mode, the 192^2+ levels) takes the plain composition.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels.loader import Kernel, load_library
from .conv import conv2d

K2 = Kernel(
    name="resblock",
    symbol="resblock_forward",
    source="ml_depth_pro_video_tpu_torch/csrc/resblock.cu",
    replaces="ml_depth_pro_video_tpu/ops/resblock.py:129",
)

FUSED_MAX_WIDTH = 96
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use


def residual_block_reference(x, w1, b1, w2, b2):
    h = conv2d(F.relu(x), w1, b1, padding=1)
    h = conv2d(F.relu(h), w2, b2, padding=1)
    return x + h


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
    if c % 8:
        raise ValueError(f"resblock kernel needs channels % 8 == 0, got {c}")
    cp = (c + 15) // 16 * 16
    if load_library().resblock_smem_bytes(cp) > _SMEM_LIMIT:
        raise ValueError(f"resblock kernel: {c} channels exceed the shared-memory budget")
    if x.numel() == 0:
        return x.clone()
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("resblock kernel needs a 16-byte aligned x")
    pad = cp - c

    def weight(wt):  # (3, 3, C, C) -> (9, Cp, Cp) bf16, zero-padded
        return F.pad(wt.to(torch.bfloat16).reshape(9, c, c), (0, pad, 0, pad)).contiguous()

    def bias(bt):  # bias rounded to bf16 as the TPU kernel reads it, then fp32
        return F.pad(bt.to(torch.bfloat16).float(), (0, pad)).contiguous()

    args = [weight(w1), bias(b1), weight(w2), bias(b2)]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (x, *args, out)]
    K2.launch(*ptr, bsz, h, w, c, cp, x.device.index, ctypes.c_void_p(stream))
    return out


class _ResidualBlock(torch.autograd.Function):
    """Forward: K2 on CUDA, the plain version on the CPU. Backward
    recomputes through the plain composition (as the JAX custom VJP does)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if x.is_cuda:
            return _resblock_cuda(x, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return residual_block_reference(x, w1, b1, w2, b2)
        raise ValueError(f"fused_residual_block: unsupported device {x.device}")

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = residual_block_reference(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
        return tuple(next(grads) if n else None for n in needs)


def fused_residual_block(x, w1, b1, w2, b2):
    """K2 on a CUDA tensor, the plain version on a CPU tensor."""
    return _ResidualBlock.apply(x, w1, b1, w2, b2)


def residual_block(x, w1, b1, w2, b2):
    """x + conv2(relu(conv1(relu(x)))), convs 3x3 pad 1."""
    c = w1.shape[2]
    if (x.dtype == torch.bfloat16 and c == w1.shape[3] == x.shape[-1]
            and x.shape[2] <= FUSED_MAX_WIDTH):
        return fused_residual_block(x, w1, b1, w2, b2)
    return residual_block_reference(x, w1, b1, w2, b2)
