"""Multi-head self-attention: the packed head-contiguous qkv layout of the
ViT, and the unpacked (B, H, S, D) layout.

Twin of ``ml_depth_pro_video_tpu/ops/attention.py``. Packed qkv is (B, S, 3*D)
as the ViT's qkv projection writes it, columns ordered
``[h0:(q,k,v) | h1:(q,k,v) | ...]``; its output is (B, S, D) head-major.

Three hand-written CUDA kernels (``csrc/attention_packed.cu``, one kernel
body read through per-tensor strides) replace the Pallas kernels:

- K1 ``flash_attention_packed``: packed qkv, no bias (the exact path);
- K3 ``flash_attention_packed_bias``: packed qkv plus an fp32 per-key score
  bias (B, S) (ToMe proportional attention: log token sizes);
- K4 ``_flash_attention``: separate q, k, v of shape (B, H, S, D).

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises. ``attention_packed`` and
``multi_head_attention`` route like the JAX package, which computes any head
dim and dtype (Pallas where it can, XLA otherwise): a head dim or dtype the
kernels do not take (``kernel_takes``) goes to the plain version. Backward
recomputes through the plain math, as the JAX custom VJPs do.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.loader import Kernel

_SOURCE = "ml_depth_pro_video_tpu_torch/csrc/attention_packed.cu"
K1 = Kernel(name="attention_packed", symbol="attention_packed_forward", source=_SOURCE,
            replaces="ml_depth_pro_video_tpu/ops/attention.py:211")
K3 = Kernel(name="attention_packed_bias", symbol="attention_packed_bias_forward",
            source=_SOURCE, replaces="ml_depth_pro_video_tpu/ops/attention.py:167")
K4 = Kernel(name="attention_bhsd", symbol="attention_bhsd_forward", source=_SOURCE,
            replaces="ml_depth_pro_video_tpu/ops/attention.py:74")

HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def kernel_takes(hd: int, dtype: torch.dtype) -> bool:
    """Whether K1, K3 and K4 compute attention at head dim ``hd`` in ``dtype``."""
    return hd in HEAD_DIMS and dtype in KERNEL_DTYPES


# ---------------------------------------------------------------------------
# plain versions


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T * hd^-0.5 + key_bias) v over (B, H, S, D); scores and
    softmax in fp32 (fp64 stays fp64), the probabilities cast to v's dtype
    before the second product. ``key_bias`` (B, S) is added to every query's
    scores per key."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * q.shape[-1] ** -0.5
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :].to(acc)
    p = torch.softmax(scores, dim=-1)
    return p.to(v.dtype) @ v


def _split_packed(qkv: torch.Tensor, num_heads: int):
    """(B, S, 3*D) head-contiguous -> q, k, v views of shape (B, H, S, hd)."""
    b, s, d3 = qkv.shape
    x = qkv.reshape(b, s, num_heads, 3, d3 // (3 * num_heads))
    return tuple(x[:, :, :, i].transpose(1, 2) for i in range(3))


def attention_packed_reference(qkv: torch.Tensor, num_heads: int,
                               key_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain packed attention (twin of ``xla_attention_packed``)."""
    b, s, d3 = qkv.shape
    out = attention_reference(*_split_packed(qkv, num_heads), key_bias)
    return out.transpose(1, 2).reshape(b, s, d3 // 3)


# ---------------------------------------------------------------------------
# kernel launches


def _check_kernel_input(name: str, t: torch.Tensor, hd: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} kernel supports head dims {HEAD_DIMS}, got {hd}")
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} kernel takes bf16 or fp32, got {t.dtype}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned tensors")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _attention_packed_cuda(qkv: torch.Tensor, num_heads: int,
                           key_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K1 (no bias) or K3 (with a bias); raise on anything they do not take."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, S, 3*H*hd) with H={num_heads}, got {tuple(qkv.shape)}")
    b, s, d3 = qkv.shape
    hd = d3 // (3 * num_heads)
    if key_bias is not None:
        if key_bias.shape != (b, s) or key_bias.device != qkv.device:
            raise ValueError(f"key_bias must be ({b}, {s}) on {qkv.device}, got "
                             f"{tuple(key_bias.shape)} on {key_bias.device}")
        key_bias = key_bias.float().contiguous()
    qkv = qkv.contiguous()
    _check_kernel_input("attention_packed", qkv, hd)
    if b == 0 or s == 0:
        return qkv.new_empty((b, s, d3 // 3))
    out = torch.empty((b, s, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    args = (b, s, num_heads, hd, int(qkv.dtype == torch.bfloat16), hd**-0.5, qkv.device.index,
            _stream(qkv))
    if key_bias is None:
        K1.launch(_ptr(qkv), _ptr(out), *args)
    else:
        K3.launch(_ptr(qkv), _ptr(key_bias), _ptr(out), *args)
    return out


def _attention_bhsd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K4; raise on anything it does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must share one dtype and one device")
    b, h, s, hd = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t in (q, k, v):
        _check_kernel_input("attention_bhsd", t, hd)
    if b * h == 0 or s == 0:
        return torch.empty_like(q)
    out = torch.empty_like(q)
    K4.launch(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, s, h, hd,
              int(q.dtype == torch.bfloat16), hd**-0.5, q.device.index, _stream(q))
    return out


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel); raise otherwise."""
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# differentiable wrappers: kernel forward, plain-math backward


class _AttentionPacked(torch.autograd.Function):
    """Forward: K1 (no bias) or K3 (bias) on CUDA, the plain version on the
    CPU. Backward recomputes through the plain math and returns gradients
    for qkv and the bias."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, key_bias: torch.Tensor | None):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, key_bias)
        if _on_cpu("attention_packed", qkv):
            return attention_packed_reference(qkv, num_heads, key_bias)
        return _attention_packed_cuda(qkv, num_heads, key_bias)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        qkv, key_bias = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [qkv.detach().requires_grad_(True)]
            if key_bias is not None:
                inputs.append(key_bias.detach().requires_grad_(True))
            out = attention_packed_reference(inputs[0], ctx.num_heads,
                                             inputs[1] if key_bias is not None else None)
            grads = torch.autograd.grad(out, inputs, grad)
        return grads[0], None, (grads[1] if key_bias is not None else None)


def attention_packed(qkv: torch.Tensor, num_heads: int,
                     key_bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S, 3*D) packed head-contiguous qkv -> (B, S, D) attention output.
    ``key_bias`` (B, S) fp32 is added to the scaled scores per key; without
    it the exact path's kernel K1 runs and reads no bias. A head dim or
    dtype the kernels do not take goes to the plain version."""
    if not kernel_takes(qkv.shape[-1] // (3 * num_heads), qkv.dtype):
        return attention_packed_reference(qkv, num_heads, key_bias)
    return _AttentionPacked.apply(qkv, num_heads, key_bias)


class _MultiHeadAttention(torch.autograd.Function):
    """Forward: K4 on CUDA, the plain version on the CPU. Backward recomputes
    through the plain math."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        ctx.save_for_backward(q, k, v)
        if _on_cpu("multi_head_attention", q):
            return attention_reference(q, k, v)
        return _attention_bhsd_cuda(q, k, v)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            return torch.autograd.grad(attention_reference(*inputs), inputs, grad)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over (B, H, S, D) tensors with 1/sqrt(D) scaling. A head
    dim or dtype the kernels do not take goes to the plain version."""
    if not kernel_takes(q.shape[-1], q.dtype):
        return attention_reference(q, k, v)
    return _MultiHeadAttention.apply(q, k, v)
