"""Normalization ops (twin of ``ml_depth_pro_video_tpu/ops/norm.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics (timm ViT eps=1e-6);
    the result is cast back to the input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)
