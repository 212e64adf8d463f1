"""Multi-head self-attention on the packed, head-contiguous qkv tensor.

Twin of ``ml_depth_pro_video_tpu/ops/attention.py::attention_packed``.
qkv is (B, S, 3*D) as the ViT's qkv projection writes it, columns ordered
``[h0:(q,k,v) | h1:(q,k,v) | ...]``; the output is (B, S, D) head-major.

``attention_packed_reference`` is the plain PyTorch version. The port's
kernel K1 (``csrc/attention_packed.cu``) replaces the Pallas kernel
``flash_attention_packed``. ``attention_packed`` takes the plain version
for a CPU tensor and launches K1 for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.loader import Kernel

K1 = Kernel(
    name="attention_packed",
    symbol="attention_packed_forward",
    source="ml_depth_pro_video_tpu_torch/csrc/attention_packed.cu",
    replaces="ml_depth_pro_video_tpu/ops/attention.py:211",
)

HEAD_DIMS = (16, 32, 64, 128)


def attention_packed_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T * hd^-0.5) v per head, scores and softmax in fp32; the
    probabilities are cast to v's dtype before the second product."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    x = qkv.reshape(b, s, num_heads, 3, hd)
    q, k, v = (x[:, :, :, i].transpose(1, 2) for i in range(3))  # (B, H, S, hd)
    acc = torch.promote_types(qkv.dtype, torch.float32)  # fp32 scores (fp64 stays fp64)
    scores = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * hd**-0.5
    p = torch.softmax(scores, dim=-1)
    out = p.to(v.dtype) @ v
    return out.transpose(1, 2).reshape(b, s, d)


def _attention_packed_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launch K1; raise on anything it does not take."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, S, 3*H*hd) with H={num_heads}, got {tuple(qkv.shape)}")
    b, s, d3 = qkv.shape
    hd = d3 // (3 * num_heads)
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention_packed kernel supports head dims {HEAD_DIMS}, got {hd}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"attention_packed kernel takes bf16 or fp32, got {qkv.dtype}")
    if b == 0 or s == 0:
        return qkv.new_empty((b, s, d3 // 3))
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError("attention_packed kernel needs a 16-byte aligned qkv tensor")
    out = torch.empty((b, s, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    K1.launch(ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(out.data_ptr()), b, s,
              num_heads, hd, int(qkv.dtype == torch.bfloat16), hd**-0.5, qkv.device.index,
              ctypes.c_void_p(stream))
    return out


class _AttentionPacked(torch.autograd.Function):
    """Forward: K1 on CUDA, the plain version on the CPU. Backward
    recomputes through the plain math (as the JAX custom VJP does)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv)
        if qkv.is_cuda:
            return _attention_packed_cuda(qkv, num_heads)
        if qkv.device.type == "cpu":
            return attention_packed_reference(qkv, num_heads)
        raise ValueError(f"attention_packed: unsupported device {qkv.device}")

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            q = qkv.detach().requires_grad_(True)
            out = attention_packed_reference(q, ctx.num_heads)
            (g,) = torch.autograd.grad(out, q, grad)
        return g, None


def attention_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, 3*D) packed head-contiguous qkv -> (B, S, D) attention output."""
    return _AttentionPacked.apply(qkv, num_heads)
