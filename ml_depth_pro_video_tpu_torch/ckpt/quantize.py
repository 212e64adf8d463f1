"""Weight-only int8 quantization for the ViT matmul weights.

Twin of ``ml_depth_pro_video_tpu/ckpt/quantize.py``. The quantized mode
stores the stacked block matmul weights of the three ViTs (patch, image and
FOV) as int8 with one fp32 scale per (layer, output channel); each block
dequantizes its weight to the compute dtype right before the matmul
(``models/vit.py::_dense``). Its point is the resident size: the ViT-L block
matmuls are 302 M parameters per ViT, 906 M for the three, a quarter of
their fp32 bytes as int8. It is not the fp32 parity mode: the codes round
each weight to 1/127 of its channel's largest magnitude.

The codes and scales equal the JAX package's bit for bit (absmax over din,
``absmax / 127`` or 1 for an all-zero channel, round half to even, clip to
[-127, 127]), so a tree quantized by either package runs in both.
"""

from __future__ import annotations

import torch

_QUANT_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def _quantize(w: torch.Tensor) -> dict:
    """(L, din, dout) -> {'q': int8, 's': fp32 (L, 1, dout)}, on ``w``'s device."""
    w = w.float()
    absmax = w.abs().amax(dim=1, keepdim=True)  # per (layer, out-channel)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which rounds differently from numpy's division
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _map_vit(vit_params: dict, fn) -> dict:
    """Apply ``fn`` to one ViT's block matmul weight leaves."""
    blocks = dict(vit_params["blocks"])
    for key in _QUANT_KEYS:
        blocks[key] = fn(blocks[key])
    return {**vit_params, "blocks": blocks}


def quantize_vit(vit_params: dict) -> dict:
    """One ViT's tree with its block matmul weights int8-quantized (Video
    Depth Anything's control, ``models/video_depth_anything.py``)."""
    return _map_vit(vit_params, _quantize)


def _map_vit_matmuls(params: dict, fn) -> dict:
    """Apply ``fn`` to every ViT block matmul weight leaf (encoder
    patch/image ViTs and the FOV ViT), leaving the rest untouched."""

    out = dict(params)
    enc = dict(params["encoder"])
    enc["patch_vit"] = _map_vit(enc["patch_vit"], fn)
    enc["image_vit"] = _map_vit(enc["image_vit"], fn)
    out["encoder"] = enc
    if "fov" in params:
        fov = dict(params["fov"])
        fov["vit"] = _map_vit(fov["vit"], fn)
        out["fov"] = fov
    return out


def quantize_vit_weights(params: dict) -> dict:
    """Return params with every ViT block matmul weight int8-quantized
    (encoder patch/image ViTs and the FOV ViT)."""
    return _map_vit_matmuls(params, _quantize)


def materialize_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """Dense weight for a matmul in ``dtype``: a plain tensor, or a quantized
    ``{'q', 's'}`` dict whose product is taken in ``dtype``, in JAX's order."""
    if isinstance(w, dict):
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w.to(dtype)
