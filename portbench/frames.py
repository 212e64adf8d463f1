"""Seeded frames: smooth, textured uint8 images made on the device.

Each frame sums three octaves of seeded noise (coarse shapes, mid-scale
texture, fine grain), upsampled bilinearly, so that neighbouring pixels and
tokens are alike as in camera frames, and maps them to [0, 255].
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

_OCTAVES = ((18, 0.6), (72, 0.3), (288, 0.1))  # (cells across the longer side, amplitude)


def make_frames(n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """(n, h, w, 3) uint8 frames for ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63 ^ 0x5EED)
    out = torch.zeros((n, 3, h, w), device=device)
    for cells, amp in _OCTAVES:
        gh, gw = max(2, cells * h // max(h, w)), max(2, cells * w // max(h, w))
        noise = torch.randn((n, 3, gh, gw), generator=gen, device=device)
        out += amp * F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=False)
    out = (out - out.mean()) / (out.std() + 1e-6)
    frames = (127.5 + 55.0 * out).clamp(0, 255).round().to(torch.uint8)
    return frames.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def encode_png(frame: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def encode_pngs(frames: np.ndarray, workers: int = 4) -> list[bytes]:
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(encode_png, list(frames)))
