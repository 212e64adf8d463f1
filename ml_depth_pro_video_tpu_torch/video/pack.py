"""Packed depth fetch: log-domain uint16 codes made on the device.

Twin of ``ml_depth_pro_video_tpu/video/pack.py``. The streaming runner's
steady device-to-host traffic is the depth map itself (fp32, 8.3 MB for a
1080x1920 frame). ``pack_depth_u16`` quantizes it on the device to uint16
in LOG depth, which halves the bytes fetched: uniform steps in log depth
give a constant relative error of ``(log(dmax) - log(dmin)) / (2 * 65535)``
per frame, at most ``max_rel_error()`` (1.4e-4) over the model's whole
output clamp of 1e-4..1e4 m. Linear steps in depth or inverse depth would
put 15-30% relative error on the near or far end of a wide scene.

The pack is elementwise passes plus a per-frame min and max in fp32 on the
un-fetched device tensor (after the temporal smoother, ``video/temporal.py``,
when that is on). ``unpack_depth_u16`` runs on the host through a per-frame
65536-entry lookup table, bit-identical to the elementwise
``exp(code * log_scale + log_min)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# depth is clipped here before the log; the model's own output clamp
# (1e-4..1e4) lies strictly inside, so no real value is touched
_CLIP = (1e-6, 1e6)
_U16_MAX = 65535.0


def pack_depth_u16(depth: torch.Tensor):
    """Quantize (B, H, W) metric depth to log-domain uint16 on its device.

    Returns ``(packed uint16 (B, H, W), log_min (B,), log_scale (B,))``, all
    on the input's device, with ``depth ~ exp(packed * log_scale + log_min)``.
    A constant map packs to zeros with ``log_scale = 0`` and unpacks exactly.
    """
    log_d = torch.log(depth.float().clamp(*_CLIP))
    lmin = log_d.amin(dim=(1, 2))
    lmax = log_d.amax(dim=(1, 2))
    scale = (lmax - lmin) / _U16_MAX
    # constant map: the numerator is identically 0, any safe divisor works
    inv = 1.0 / torch.where(scale > 0.0, scale, torch.ones_like(scale))
    u = torch.round((log_d - lmin[:, None, None]) * inv[:, None, None])
    return u.to(torch.uint16), lmin, scale


def unpack_depth_u16(packed: np.ndarray, log_min: np.ndarray,
                     log_scale: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`pack_depth_u16`.

    ``packed``: (..., H, W) uint16; ``log_min`` / ``log_scale``: one value per
    frame (or scalars). Returns fp32 metric depth of ``packed``'s shape.
    """
    packed = np.asarray(packed)
    lmin = np.asarray(log_min, np.float32).reshape(-1)
    lscale = np.asarray(log_scale, np.float32).reshape(-1)
    if packed.dtype != np.uint16:
        raise TypeError(f"packed must be uint16, got {packed.dtype}")
    # 65536 codes against ~2M pixels a frame: exp() through a per-frame table
    # is ~30x fewer transcendentals. lut[u] evaluates exp(float32(u) * lscale
    # + lmin) on exactly the fp32 inputs of the elementwise form, so the
    # result is bit-identical.
    codes = np.arange(_U16_MAX + 1, dtype=np.float32)
    flat = packed.reshape(-1, *packed.shape[-2:]) if packed.ndim >= 2 else packed[None]
    n = flat.shape[0]
    if lmin.size not in (1, n) or lscale.size not in (1, n):
        raise ValueError(f"log_min/log_scale shapes {np.shape(log_min)}/{np.shape(log_scale)} "
                         f"do not broadcast over {n} frames of shape {packed.shape}")
    out = np.empty(flat.shape, np.float32)
    for i in range(n):
        lut = np.exp(codes * lscale[i % lscale.size] + lmin[i % lmin.size])
        out[i] = lut[flat[i]]
    return out.reshape(packed.shape)


@functools.cache
def max_rel_error(log_range: float = float(np.log(1e4 / 1e-4))) -> float:
    """Worst-case relative quantization error of the u16 log packing for a
    frame whose log-depth spread is ``log_range`` (default: the model's whole
    output clamp, 1e-4..1e4 m). Excludes the device's fp32 ``log`` error."""
    return float(np.expm1(log_range / (2.0 * _U16_MAX)))
