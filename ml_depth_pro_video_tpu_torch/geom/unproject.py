"""Depth-map -> 3D point unprojection.

Pinhole unprojection with the reference's world convention
(`img_to_normalized_pointcloud.py:819-856`): principal point at the
image center, X negated (preserve left/right) and Y negated (Y-up
world). ``unproject_dense`` is the dense form on tensors, on whatever
device the depth lies; the host wrapper ``depth_to_3d`` filters invalid
depths and attaches colors.

The port's version of ``ml_depth_pro_video_tpu/geom/unproject.py``
(``depth_to_3d`` is host code copied as it is: the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from .pointcloud import PointCloud


def unproject_dense(depth: torch.Tensor, f_px) -> torch.Tensor:
    """Dense unprojection on ``depth``'s device.

    depth: (..., H, W); f_px: scalar or broadcastable to (...,).
    Returns (..., H, W, 3) with (x, y, z) in the Y-up world frame.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    xs = torch.arange(w, dtype=torch.float32, device=depth.device) - w / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=depth.device) - h / 2.0
    f = torch.as_tensor(f_px, dtype=torch.float32).to(depth.device)[..., None, None]
    x = -xs[None, :] * depth / f
    y = -ys[:, None] * depth / f
    return torch.stack([x, y, depth], dim=-1)


def depth_to_3d(depth, focallength_px, image=None, max_depth=None):
    """Host unprojection: filter invalid depths, optional color attach.

    Args:
      depth: (H, W) depth map [m].
      focallength_px: focal length in pixels.
      image: optional (H, W, 3) uint8/float image for per-point colors.
      max_depth: optional far-plane cutoff [m].

    Returns:
      (points (N,3) float64, valid_mask (H,W) bool) — or a PointCloud
      when ``image`` is given.
    """
    dep = np.asarray(depth)
    if dep.dtype == np.float32 and (image is None or image.dtype == np.uint8):
        # hot path: single native pass (exact same math/compaction; the
        # fp32 depth widens losslessly to the float64 the numpy path uses)
        try:
            from ..native import neighbors as _native

            out = _native.unproject_valid(dep, float(focallength_px),
                                          image=image, max_depth=max_depth)
        except Exception:  # pragma: no cover
            out = None
        if out is not None:
            points, valid, colors = out
            if image is None:
                return points, valid
            return PointCloud(points, colors)
    depth_np = np.asarray(depth, dtype=np.float64)
    h, w = depth_np.shape
    valid = ~np.isnan(depth_np) & (depth_np > 0)
    if max_depth is not None:
        valid &= depth_np < max_depth

    ys, xs = np.nonzero(valid)
    z = depth_np[ys, xs]
    x = -(xs - w / 2.0) * z / focallength_px
    y = -(ys - h / 2.0) * z / focallength_px
    points = np.column_stack([x, y, z])

    if image is None:
        return points, valid
    img = np.asarray(image)
    colors = img[ys, xs].astype(np.float64)
    # colors.max() on an EMPTY selection (no valid depth) would raise;
    # empty clouds degrade gracefully like the reference
    if img.dtype == np.uint8 or (len(colors) and colors.max() > 1.0):
        colors = colors / 255.0
    return PointCloud(points, colors)
