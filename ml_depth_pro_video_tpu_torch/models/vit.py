"""DINOv2-style ViT backbone (twin of ``ml_depth_pro_video_tpu/models/vit.py``).

Patch embed 16x16/s16 as patchify + matmul, cls token, learned pos embed,
pre-norm blocks with LayerScale and exact GELU, eps=1e-6 LayerNorms, and a
final LayerNorm. Block params are stacked along a leading depth axis; a
Python loop over that axis replaces the JAX package's ``lax.scan``.
Attention runs on the packed head-contiguous qkv through
``ops.attention.attention_packed`` (kernel K1 on CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ckpt.params import ParamTree
from ..core.precision import Precision
from ..ops.attention import attention_packed
from ..ops.norm import layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT backbone configuration (default: dinov2l16_384)."""

    img_size: int = 384
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid_size * self.grid_size + 1


VIT_CONFIG_DICT = {
    "dinov2l16_384": ViTConfig(img_size=384, patch_size=16, embed_dim=1024, depth=24,
                               num_heads=16, mlp_ratio=4),
    "dinov2b16_384": ViTConfig(img_size=384, patch_size=16, embed_dim=768, depth=12,
                               num_heads=12, mlp_ratio=4),
    "dinov2s16_384": ViTConfig(img_size=384, patch_size=16, embed_dim=384, depth=12,
                               num_heads=6, mlp_ratio=4),
}


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, S, S, C) -> (B, G*G, patch*patch*C), (kh, kw, c)-ordered."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype, the bias added inside the GEMM (one pass over
    the output instead of a second elementwise one)."""
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _block(x: torch.Tensor, bp: dict, cfg: ViTConfig) -> torch.Tensor:
    cdt = x.dtype
    h = layer_norm(x, bp["ln1_g"], bp["ln1_b"], cfg.layer_norm_eps)
    attn = attention_packed(_dense(h, bp["qkv_w"], bp["qkv_b"]), cfg.num_heads)
    x = torch.addcmul(x, bp["ls1"].to(cdt), _dense(attn, bp["proj_w"], bp["proj_b"]))

    h = layer_norm(x, bp["ln2_g"], bp["ln2_b"], cfg.layer_norm_eps)
    h = F.gelu(_dense(h, bp["fc1_w"], bp["fc1_b"]))
    return torch.addcmul(x, bp["ls2"].to(cdt), _dense(h, bp["fc2_w"], bp["fc2_b"]))


def vit_apply(params: dict, x: torch.Tensor, cfg: ViTConfig,
              precision: Precision = Precision.fp32(),
              capture_blocks: Sequence[int] = (),
              merge_ratio: float = 0.0) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """x: (B, img, img, 3) normalized NHWC. Returns (final tokens after the
    last LayerNorm, [outputs of the blocks in ``capture_blocks``, in sorted
    order]), each (B, 1+G*G, D)."""
    if merge_ratio > 0.0:
        raise NotImplementedError("token merging (--speed balanced/fast) is not ported yet")
    cdt = precision.compute_dtype
    b = x.shape[0]
    tokens = _dense(patchify(x.to(cdt), cfg.patch_size), params["patch_embed"]["w"],
                    params["patch_embed"]["b"])
    cls = params["cls_token"].to(cdt).expand(b, 1, cfg.embed_dim)
    tokens = torch.cat([cls, tokens], dim=1) + params["pos_embed"].to(cdt)

    wanted = sorted(capture_blocks)
    captures = []
    blocks = params["blocks"]
    for i in range(cfg.depth):
        tokens = _block(tokens, {k: v[i] for k, v in blocks.items()}, cfg)
        captures.extend(tokens for idx in wanted if idx == i)
    tokens = layer_norm(tokens, params["norm"]["g"], params["norm"]["b"], cfg.layer_norm_eps)
    return tokens, captures


class ViT(nn.Module):
    """A ViT backbone: its param tree as module parameters, and
    ``vit_apply`` as the forward."""

    def __init__(self, params: dict, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, x: torch.Tensor, precision: Precision = Precision.fp32(),
                capture_blocks: Sequence[int] = ()):
        return vit_apply(self.tree(), x, self.cfg, precision, capture_blocks)
