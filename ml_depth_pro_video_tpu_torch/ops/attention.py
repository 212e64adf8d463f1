"""Multi-head self-attention: the packed head-contiguous qkv layout of the
ViT, and the unpacked (B, H, S, D) layout.

Twin of ``ml_depth_pro_video_tpu/ops/attention.py``. Packed qkv is (B, S, 3*D)
as the ViT's qkv projection writes it, columns ordered
``[h0:(q,k,v) | h1:(q,k,v) | ...]``; its output is (B, S, D) head-major.

Three hand-written CUDA kernels (entry points and dispatch in
``csrc/attention_packed.cu``, each body read through per-tensor strides)
replace the Pallas kernels:

- K1 ``flash_attention_packed``: packed qkv, no bias (the exact path);
- K3 ``flash_attention_packed_bias``: packed qkv plus an fp32 per-key score
  bias (B, S) (ToMe proportional attention: log token sizes);
- K4 ``_flash_attention``: separate q, k, v of shape (B, H, S, D).

In bf16 at head dim 64, K1, K3 and K4 run the wgmma + TMA body of
``csrc/attention_wgmma.cu``; fp32 and the other head dims the bodies of
``csrc/attention_packed.cu`` (``attention_body`` says which a shape takes).

Each kernel is a ``torch.library`` custom operator, so that a traced graph
(``torch.export``, ``torch.compile``) names the kernel it runs:
``depth_pro::attention_packed`` (K1), ``depth_pro::attention_packed_bias``
(K3) and ``depth_pro::attention_bhsd`` (K4). Its CUDA kernel launches the
hand-written kernel (pointers, alignment checks and the stream are read
there only), its CPU kernel is the plain PyTorch version, and a tensor on
any other device raises; a fake kernel gives the output's shape to tracing.
``attention_packed`` and ``multi_head_attention`` route like the JAX
package, which computes any head dim and dtype (Pallas where it can, XLA
otherwise): a head dim or dtype the kernels do not take (``kernel_takes``)
goes to the plain version. Backward recomputes through the plain math, as
the JAX custom VJPs do.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.loader import Kernel, KernelLaunchError, load_library

_WGMMA_SOURCE = "ml_depth_pro_video_tpu_torch/csrc/attention_wgmma.cu"  # bf16 at hd 64
K1 = Kernel(name="attention_packed", symbol="attention_packed_forward", source=_WGMMA_SOURCE,
            replaces="ml_depth_pro_video_tpu/ops/attention.py:211")
K3 = Kernel(name="attention_packed_bias", symbol="attention_packed_bias_forward",
            source=_WGMMA_SOURCE, replaces="ml_depth_pro_video_tpu/ops/attention.py:167")
K4 = Kernel(name="attention_bhsd", symbol="attention_bhsd_forward", source=_WGMMA_SOURCE,
            replaces="ml_depth_pro_video_tpu/ops/attention.py:74")

# csrc/attention_packed.cu::body_of's codes
BODIES = {0: "fp32", 1: "mma.sync", 2: "wgmma"}

HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def kernel_takes(hd: int, dtype: torch.dtype) -> bool:
    """Whether K1, K3 and K4 compute attention at head dim ``hd`` in ``dtype``."""
    return hd in HEAD_DIMS and dtype in KERNEL_DTYPES


def attention_body(batch: int, s: int, heads: int, hd: int, dtype: torch.dtype,
                   device: int = 0) -> tuple[str, int]:
    """The body a K1, K3 or K4 call of this shape takes on CUDA device
    ``device`` (``"wgmma"``, ``"mma.sync"`` or ``"fp32"``) and its queries per
    block: a function of the shape alone, the same with or without a bias."""
    body, rows = ctypes.c_int(), ctypes.c_int()
    err = load_library().attention_kernel_body(batch, s, heads, hd,
                                               int(dtype == torch.bfloat16), device,
                                               ctypes.byref(body), ctypes.byref(rows))
    if err:
        raise KernelLaunchError(f"attention_kernel_body returned cudaError {err}")
    return BODIES[body.value], rows.value


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
        if key_bias.data_ptr() % 16:  # the wgmma body loads it by TMA: a fresh, aligned copy
            key_bias = key_bias.clone()
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


# ---------------------------------------------------------------------------
# the kernels as operators: a CUDA kernel (the hand-written one), a CPU kernel
# (the plain version), a fake kernel that reads only shapes (so torch.export,
# torch.compile and AOTAutograd trace through them) and a backward that
# recomputes through the plain math, as the JAX custom VJPs do. No default
# kernel: a tensor on any other device raises in the dispatcher.


@torch.library.custom_op("depth_pro::attention_packed", mutates_args=(), device_types="cuda")
def attention_packed_op(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K1: (B, S, 3*D) packed qkv -> (B, S, D)."""
    return _attention_packed_cuda(qkv, num_heads)


@torch.library.custom_op("depth_pro::attention_packed_bias", mutates_args=(),
                         device_types="cuda")
def attention_packed_bias_op(qkv: torch.Tensor, key_bias: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """K3: K1 plus an fp32 per-key score bias (B, S)."""
    return _attention_packed_cuda(qkv, num_heads, key_bias)


@torch.library.custom_op("depth_pro::attention_bhsd", mutates_args=(), device_types="cuda")
def attention_bhsd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: attention over (B, H, S, D) q, k, v."""
    return _attention_bhsd_cuda(q, k, v)


@attention_packed_op.register_kernel("cpu")
def _(qkv, num_heads):
    return attention_packed_reference(qkv, num_heads)


@attention_packed_bias_op.register_kernel("cpu")
def _(qkv, key_bias, num_heads):
    return attention_packed_reference(qkv, num_heads, key_bias)


@attention_bhsd_op.register_kernel("cpu")
def _(q, k, v):
    return attention_reference(q, k, v)


def _packed_fake(qkv, *_):
    b, s, d3 = qkv.shape
    return qkv.new_empty((b, s, d3 // 3))


attention_packed_op.register_fake(_packed_fake)
attention_packed_bias_op.register_fake(_packed_fake)
attention_bhsd_op.register_fake(lambda q, k, v: q.new_empty(q.shape))


def plain_vjp(fn, inputs, grad, needs=None) -> tuple:
    """Gradients of ``fn(*inputs)`` against ``grad`` through its plain math,
    for the inputs ``needs`` marks (all by default; None for the others and
    for an input that is None). Where ``fn`` returns a tuple, ``grad`` is a
    tuple too, and an output that needs no gradient (an operator's empty
    placeholder) is left out."""
    needs = needs or (True,) * len(inputs)
    with torch.enable_grad():
        ins = [t if t is None else t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = fn(*ins)
        if isinstance(outs, torch.Tensor):
            outs, grad = (outs,), (grad,)
        pairs = [(o, g) for o, g in zip(outs, grad) if o.requires_grad]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs]))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in ins)


def save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _save_packed(ctx, inputs, output):
    *tensors, ctx.num_heads = inputs
    ctx.save_for_backward(*tensors)


def _packed_backward(ctx, grad):
    """Gradients for qkv (and the bias of K3); none for ``num_heads``."""
    return (*plain_vjp(lambda qkv, *bias: attention_packed_reference(qkv, ctx.num_heads, *bias),
                       ctx.saved_tensors, grad, ctx.needs_input_grad[:-1]), None)


def _bhsd_backward(ctx, grad):
    return plain_vjp(attention_reference, ctx.saved_tensors, grad, ctx.needs_input_grad)


attention_packed_op.register_autograd(_packed_backward, setup_context=_save_packed)
attention_packed_bias_op.register_autograd(_packed_backward, setup_context=_save_packed)
attention_bhsd_op.register_autograd(_bhsd_backward, setup_context=save_inputs)


def attention_packed(qkv: torch.Tensor, num_heads: int,
                     key_bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S, 3*D) packed head-contiguous qkv -> (B, S, D) attention output.
    ``key_bias`` (B, S) fp32 is added to the scaled scores per key; without
    it the exact path's kernel K1 runs and reads no bias, with it K3. A head
    dim or dtype the kernels do not take goes to the plain version."""
    if not kernel_takes(qkv.shape[-1] // (3 * num_heads), qkv.dtype):
        return attention_packed_reference(qkv, num_heads, key_bias)
    if key_bias is None:
        return attention_packed_op(qkv, num_heads)
    return attention_packed_bias_op(qkv, key_bias, num_heads)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over (B, H, S, D) tensors with 1/sqrt(D) scaling (K4). A
    head dim or dtype the kernel does not take goes to the plain version."""
    if not kernel_takes(q.shape[-1], q.dtype):
        return attention_reference(q, k, v)
    return attention_bhsd_op(q, k, v)
