"""Plain PyTorch toy window model: each frame's inverse depth depends on
every frame of its window.

A frame's 4x4 patches are embedded, then attend over time: at each patch
position, the window's frames are one sequence (multi-head self-attention
along the time axis, as a temporal head does), with a residual; a linear
head and a softplus give the inverse depth of each patch, repeated over its
pixels. Matmuls run in ``dtype`` and return fp32; softmax runs in fp32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Arch:
    window: int = 8     # frames a window
    overlap: int = 2    # frames a window carries over from the one before
    patch: int = 4
    channels: int = 16
    heads: int = 2


def arch_of(config: dict) -> Arch:
    m = config["model"]
    return Arch(window=m["window"], overlap=m["overlap"], patch=m["patch"],
                channels=m["channels"], heads=m["heads"])


def dense(x, w, dtype):
    return (x.to(dtype) @ w.to(dtype)).float()


def infer(params: dict, frames: torch.Tensor, arch: Arch, dtype) -> torch.Tensor:
    """(T, H, W, 3) uint8 frames of one window -> (T, H, W) fp32 inverse depth."""
    t, h, w, _ = frames.shape
    p, c, heads = arch.patch, arch.channels, arch.heads
    x = frames.float() / 127.5 - 1.0
    x = x.reshape(t, h // p, p, w // p, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(t, (h // p) * (w // p), p * p * 3)
    e = dense(x, params["embed"], dtype)                      # (T, N, C)
    qkv = dense(e, params["qkv"], dtype)                      # (T, N, 3C)
    q, k, v = qkv.reshape(t, -1, 3, heads, c // heads).unbind(2)
    out = torch.empty_like(e)
    for n in range(e.shape[1]):                               # each patch position
        for hd in range(heads):
            qs, ks, vs = q[:, n, hd], k[:, n, hd], v[:, n, hd]   # (T, c / heads)
            att = torch.softmax(dense(qs, ks.T, dtype) * (c // heads) ** -0.5, dim=-1)
            out[:, n, hd * (c // heads):(hd + 1) * (c // heads)] = dense(att, vs, dtype)
    e = e + dense(out, params["out"], dtype)
    inv = F.softplus(dense(e, params["head"], dtype)[..., 0]) + 0.1   # (T, N)
    inv = inv.reshape(t, h // p, w // p)
    return inv.repeat_interleave(p, 1).repeat_interleave(p, 2)
