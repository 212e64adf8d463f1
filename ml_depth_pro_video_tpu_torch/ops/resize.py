"""Image resize with torch ``F.interpolate(align_corners=False)`` semantics.

Twin of ``ml_depth_pro_video_tpu/ops/resize.py::resize2d``. The JAX package
reproduces ``F.interpolate`` with dense interpolation matrices whose
weights are computed in fp64. Here the same taps and weights (fp64, then
fp32) are applied as a gather and a weighted sum along each axis, which
costs a few taps per output pixel instead of a dense matmul.
``F.interpolate`` itself computes its source coordinates in fp32, which
puts it ~1e-4 away from the exact weights on noisy images.
``resize_matrix`` folds the same taps into the JAX package's dense
(out, in) matrix, which the checkpoint converter applies in fp64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_filter(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys), a=-0.75: torch's convention."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(ax <= 1.0, (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
                    np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0))


def _linear_filter(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_FILTERS = {"bilinear": (_linear_filter, 1.0), "linear": (_linear_filter, 1.0),
            "bicubic": (_cubic_filter, 2.0), "cubic": (_cubic_filter, 2.0)}


def _check_mode(mode: str) -> None:
    if mode not in _FILTERS:
        raise ValueError(f"Unsupported resize mode {mode!r}; expected one of {sorted(_FILTERS)}")


@functools.lru_cache(maxsize=256)
def resize_taps(in_size: int, out_size: int, mode: str = "bilinear",
                antialias: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(indices (out, ntaps) int64, weights (out, ntaps) fp32): output i is
    ``sum_t weights[i, t] * input[indices[i, t]]``. Border taps are clamped
    to the edge (torch's index clamping); with ``antialias`` the kernel is
    truncated at the border and renormalized (torch/PIL)."""
    idx, w = _taps64(in_size, out_size, mode, antialias)
    return idx, w.astype(np.float32)


def _taps64(in_size: int, out_size: int, mode: str,
            antialias: bool) -> tuple[np.ndarray, np.ndarray]:
    """:func:`resize_taps` with the weights still in fp64."""
    _check_mode(mode)
    filt, radius = _FILTERS[mode]
    if antialias and mode in ("bicubic", "cubic"):
        filt = functools.partial(_cubic_filter, a=-0.5)  # PIL's anti-aliased bicubic
    scale = in_size / out_size
    support_scale = max(scale, 1.0) if antialias else 1.0
    support = radius * support_scale
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(center - support + 1.0).astype(np.int64)
    ntaps = int(np.ceil(2.0 * support)) + 1
    taps = lo[:, None] + np.arange(ntaps)[None, :]
    w = filt((taps - center[:, None]) / support_scale) / support_scale
    if antialias:
        w = np.where((taps >= 0) & (taps < in_size), w, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    w = np.where(wsum > 0, w / wsum, w)
    return np.clip(taps, 0, in_size - 1), w


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, mode: str = "bilinear",
                  antialias: bool = False) -> np.ndarray:
    """Dense (out_size, in_size) row-stochastic matrix of the same resize
    (twin of ``ml_depth_pro_video_tpu/ops/resize.py::resize_matrix``): the
    identity when the sizes match, else the taps of :func:`resize_taps` with
    the weights of clamped border taps summed, fp64 folded to fp32."""
    _check_mode(mode)
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    idx, w = _taps64(in_size, out_size, mode, antialias)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), idx.shape[1]), idx.ravel()), w.ravel())
    return mat.astype(np.float32)


def _resize_axis(x: torch.Tensor, axis: int, out_size: int, mode: str,
                 antialias: bool) -> torch.Tensor:
    idx, w = resize_taps(x.shape[axis], out_size, mode, antialias)
    idx_t = torch.as_tensor(idx, device=x.device)
    w_t = torch.as_tensor(w, device=x.device)
    g = x.index_select(axis, idx_t.flatten())
    g = g.unflatten(axis, idx.shape)                       # (..., out, ntaps, ...)
    w_t = w_t.reshape(idx.shape + (1,) * (x.dim() - axis - 1))
    return (g * w_t).sum(axis + 1)


def resize2d(x: torch.Tensor, out_hw: tuple[int, int], mode: str = "bilinear",
             antialias: bool = False) -> torch.Tensor:
    """Resize (..., H, W, C) images to ``out_hw``. Computes in fp32 and
    returns the input's dtype."""
    oh, ow = out_hw
    h_axis, w_axis = x.dim() - 3, x.dim() - 2
    xf = x.float()
    if oh != x.shape[h_axis]:
        xf = _resize_axis(xf, h_axis, oh, mode, antialias)
    if ow != x.shape[w_axis]:
        xf = _resize_axis(xf, w_axis, ow, mode, antialias)
    return xf.to(x.dtype)
