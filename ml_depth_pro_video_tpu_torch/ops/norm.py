"""Normalization ops (twin of ``ml_depth_pro_video_tpu/ops/norm.py``), and the
ViT block's residual add with LayerScale fused into the LayerNorm after it.

``add_layer_norm`` computes ``x_new = x + bf16(ls) * branch`` and
``y = LayerNorm(x_new)``, or either half alone. Kernel K5
(``csrc/add_layer_norm.cu``) does it in one pass over the rows for bf16 CUDA
tensors whose width is a multiple of 8 up to 4096 (``k5_takes``); it is the
custom operator ``depth_pro::add_layer_norm``, so a traced graph names it. The
fp32 parity mode, CPU tensors and other widths take the plain composition
(``add_layer_norm_reference``: ``torch.addcmul`` and the fp32 LayerNorm), as
the JAX package leaves this glue to XLA, which fuses it. K5's ``x_new`` is
the plain composition's bit for bit; its LayerNorm output lies within one
bf16 ulp of it (the statistics are summed in another order). Backward
recomputes through the plain math, as for the other kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.loader import Kernel
from .attention import plain_vjp

K5 = Kernel(name="add_layer_norm", symbol="add_layer_norm_forward",
            source="ml_depth_pro_video_tpu_torch/csrc/add_layer_norm.cu",
            replaces="none: XLA fuses this glue of ml_depth_pro_video_tpu/models/vit.py::_block")

K5_MAX_WIDTH = 4096  # 16 chunks of 8 bf16 per lane of the row's warp


def layer_norm_reference(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics (timm ViT eps=1e-6);
    the result is cast back to the input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)


def add_layer_norm_reference(x: torch.Tensor, branch: Optional[torch.Tensor],
                             ls: Optional[torch.Tensor], g: Optional[torch.Tensor] = None,
                             b: Optional[torch.Tensor] = None, eps: float = 1e-6):
    """The plain composition: ``(x_new, y)`` with ``x_new = x + ls * branch``
    (LayerScale cast to x's dtype first; ``x`` itself where ``branch`` is
    None) and ``y`` its LayerNorm (None where ``g`` is None)."""
    if branch is not None:
        x = torch.addcmul(x, ls.to(x.dtype), branch)
    return x, (None if g is None else layer_norm_reference(x, g, b, eps))


def k5_takes(x: torch.Tensor, branch: Optional[torch.Tensor] = None) -> bool:
    """Whether K5 computes ``add_layer_norm`` on these tensors."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() > 0
            and x.shape[-1] % 8 == 0 and 0 < x.shape[-1] <= K5_MAX_WIDTH
            and (branch is None or (branch.is_cuda and branch.dtype == torch.bfloat16)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a fresh copy of a view that is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _add_layer_norm_cuda(x, branch, ls, g, b, eps):
    """Launch K5; raise on anything it does not take. Returns (x_new, y), an
    empty tensor for the half the mode does not compute."""
    add, norm = branch is not None, g is not None
    if add != (ls is not None) or norm != (b is not None) or not (add or norm):
        raise ValueError("add_layer_norm takes branch with ls, g with b, or both pairs")
    if x.dtype != torch.bfloat16 or (add and branch.dtype != torch.bfloat16):
        raise ValueError(f"add_layer_norm kernel takes bf16 x and branch, got {x.dtype}"
                         + (f" and {branch.dtype}" if add else ""))
    d = x.shape[-1] if x.dim() else 0
    if d % 8 or not 0 < d <= K5_MAX_WIDTH:
        raise ValueError(f"add_layer_norm kernel needs a width % 8 == 0 and <= {K5_MAX_WIDTH}, "
                         f"got {d}")
    if add and branch.shape != x.shape:
        raise ValueError(f"branch must be x's shape {tuple(x.shape)}, got {tuple(branch.shape)}")
    params = [t for t in (ls, g, b) if t is not None]
    if any(t.shape != (d,) for t in params):
        raise ValueError(f"ls, g and b must be ({d},), got {[tuple(t.shape) for t in params]}")
    if any(t.device != x.device for t in [branch, *params] if t is not None):
        raise ValueError("add_layer_norm kernel needs every tensor on one device")
    x = _aligned(x)
    branch = _aligned(branch) if add else None
    ls, g, b = (None if t is None else t.float().contiguous() for t in (ls, g, b))
    x_new = torch.empty_like(x) if add else x.new_empty(0)
    y = torch.empty_like(x) if norm else x.new_empty(0)
    if x.numel():
        ptr = [ctypes.c_void_p(None if t is None else t.data_ptr())
               for t in (x, branch, ls, g, b, x_new if add else None, y if norm else None)]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        K5.launch(*ptr, x.numel() // d, d, eps, x.device.index, ctypes.c_void_p(stream))
    return x_new, y


def _placeheld(x, branch, ls, g, b, eps):
    """The operator's two outputs from the plain composition, an empty tensor
    for the half the mode does not compute."""
    x_new, y = add_layer_norm_reference(x, branch, ls, g, b, eps)
    empty = x.new_empty(0)
    return (x_new if branch is not None else empty), (y if g is not None else empty)


@torch.library.custom_op("depth_pro::add_layer_norm", mutates_args=(), device_types="cuda")
def add_layer_norm_op(x: torch.Tensor, branch: Optional[torch.Tensor],
                      ls: Optional[torch.Tensor], g: Optional[torch.Tensor],
                      b: Optional[torch.Tensor], eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 as an operator: its CUDA kernel launches K5, its CPU kernel is the
    plain composition, a tensor on any other device raises; the fake kernel
    gives tracing the outputs' shapes, and backward recomputes through the
    plain composition."""
    return _add_layer_norm_cuda(x, branch, ls, g, b, eps)


@add_layer_norm_op.register_kernel("cpu")
def _(x, branch, ls, g, b, eps):
    return _placeheld(x, branch, ls, g, b, eps)


@add_layer_norm_op.register_fake
def _(x, branch, ls, g, b, eps):
    return (x.new_empty(x.shape if branch is not None else 0),
            x.new_empty(x.shape if g is not None else 0))


def _save(ctx, inputs, output):
    *tensors, ctx.eps = inputs
    ctx.save_for_backward(*tensors)


def _backward(ctx, grad_x, grad_y):
    """Gradients for x, branch, ls, g and b (None for an absent one); none for eps."""
    return (*plain_vjp(lambda *t: _placeheld(*t, ctx.eps), ctx.saved_tensors,
                       (grad_x, grad_y), ctx.needs_input_grad[:-1]), None)


add_layer_norm_op.register_autograd(_backward, setup_context=_save)


def add_layer_norm(x: torch.Tensor, branch: Optional[torch.Tensor],
                   ls: Optional[torch.Tensor], g: Optional[torch.Tensor] = None,
                   b: Optional[torch.Tensor] = None, eps: float = 1e-6):
    """``(x_new, y)``: ``x_new = x + ls * branch`` (``x`` where ``branch`` is
    None) and ``y = LayerNorm(x_new)`` (None where ``g`` is None). K5 where
    ``k5_takes``, the plain composition elsewhere."""
    if not k5_takes(x, branch):
        return add_layer_norm_reference(x, branch, ls, g, b, eps)
    x_new, y = add_layer_norm_op(x, branch, ls, g, b, eps)
    return (x if branch is None else x_new), (None if g is None else y)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics (timm ViT eps=1e-6);
    the result is cast back to the input dtype. K5's LayerNorm-only mode
    where ``k5_takes``."""
    return add_layer_norm(x, None, None, g, b, eps)[1]
