"""Depth-map-space shadow removal.

Capability parity with the reference's legacy depth-space cleanup
(the reference's `OLD_SCRIPTS/mesh_from_depth.py:1110-1171` shadow
detection, `:1613-...` removal with ground interpolation,
`force_horizontal_ground` `:1172`): monocular-depth "shadows" show up
as thin regions bounded by abrupt depth discontinuities; they are
detected from gradient magnitude (optionally fused with image edges)
and filled with the analytic ground-plane depth along each pixel ray.

Copy of ``ml_depth_pro_video_tpu/geom/depth_shadows.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from .ground import fit_ground_plane
from .unproject import depth_to_3d


def find_depth_shadows(depth_map: np.ndarray, threshold_factor: float = 0.2,
                       min_region_size: int = 100,
                       image: np.ndarray | None = None) -> np.ndarray:
    """Boolean mask of shadow pixels (discontinuity-bounded small regions)."""
    from scipy import ndimage

    depth = np.asarray(depth_map, dtype=np.float64)
    gx = ndimage.sobel(depth, axis=1)
    gy = ndimage.sobel(depth, axis=0)
    grad = np.hypot(gx, gy)
    if grad.max() > 0:
        grad = grad / grad.max()

    if image is not None:
        import cv2

        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) if image.ndim == 3 else image
        edges = cv2.Canny(gray.astype(np.uint8), 50, 150) / 255.0
        grad = np.maximum(grad, edges)

    edge_mask = grad > threshold_factor
    labels, n = ndimage.label(~edge_mask)
    if n == 0:
        return edge_mask
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, index=range(1, n + 1))
    valid = np.where(sizes >= min_region_size)[0] + 1
    return ~np.isin(labels, valid)


def force_horizontal_ground(ground_model: dict, max_angle: float = 5.0,
                            completely_flat: bool = False) -> dict:
    """Clamp the ground normal to within ``max_angle`` of vertical (or make
    it perfectly horizontal). The clamp is an exact Rodrigues rotation of
    the normal towards vertical by (angle - max_angle) — the reference's
    construction (`mesh_from_depth.py:1218-1229`); a lerp-and-normalize
    would systematically undershoot the target angle."""
    up = np.array([0.0, 1.0, 0.0])
    normal = np.asarray(ground_model["normal"], dtype=np.float64)
    if normal[1] < 0:
        normal = -normal
    out = dict(ground_model)
    angle = np.degrees(np.arccos(np.clip(normal @ up, -1, 1)))
    if completely_flat or angle > max_angle:
        if completely_flat or angle < 1e-9:
            new_normal = up
        else:
            axis = np.cross(normal, up)
            axis_n = np.linalg.norm(axis)
            if axis_n < 1e-12:
                new_normal = up
            else:
                axis /= axis_n
                theta = np.radians(angle - max_angle)
                k = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                r = np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)
                new_normal = r @ normal
                new_normal /= np.linalg.norm(new_normal)
        out["normal"] = new_normal
        out["d"] = -float(new_normal @ np.asarray(ground_model["origin"], dtype=np.float64))
    return out


def ground_depth_along_rays(shape: tuple[int, int], f_px: float,
                            ground_model: dict) -> np.ndarray:
    """Analytic depth where each pixel ray intersects the ground plane
    (NaN where the ray never hits it), using the Y-up unprojection
    convention (x and y negated, center principal point)."""
    h, w = shape
    ys, xs = np.indices((h, w))
    dirs = np.stack([
        -(xs - w / 2.0) / f_px,
        -(ys - h / 2.0) / f_px,
        np.ones((h, w)),
    ], axis=-1)
    n = np.asarray(ground_model["normal"], dtype=np.float64)
    d = float(ground_model["d"])
    denom = dirs @ n
    with np.errstate(divide="ignore", invalid="ignore"):
        z = -d / denom
    z[(denom == 0) | (z <= 0)] = np.nan
    return z


def remove_depth_shadows(depth_map: np.ndarray, image: np.ndarray | None = None,
                         f_px: float | None = None,
                         threshold_factor: float = 0.2, min_region_size: int = 100,
                         interpolate_ground: bool = True,
                         ground_model: dict | None = None,
                         force_horizontal: bool = False,
                         max_ground_angle: float = 5.0,
                         perfectly_flat_ground: bool = False,
                         ground_band: float | None = None,
                         seed: int = 0):
    """Returns (filtered_depth, shadow_mask, ground_model)."""
    depth = np.asarray(depth_map, dtype=np.float64)
    h, w = depth.shape
    f_px = f_px if f_px is not None else float(max(h, w))

    # the reference computes the shadow mask from depth gradients ONLY —
    # its remove_depth_shadows never forwards the image into
    # find_depth_shadows (`mesh_from_depth.py:1651`); the image fusion
    # remains available on find_depth_shadows for direct callers
    shadow = find_depth_shadows(depth, threshold_factor, min_region_size)
    out = depth.copy()

    if not interpolate_ground:
        # reference: no interpolation -> the depth map is returned
        # unmodified (shadow pixels keep their original values)
        return out, shadow, ground_model

    if ground_model is None:
        points, _ = depth_to_3d(depth, f_px)
        ground_model = fit_ground_plane(points, seed=seed)
    if force_horizontal or perfectly_flat_ground:
        ground_model = force_horizontal_ground(ground_model, max_ground_angle,
                                               perfectly_flat_ground)

    # Reference fill semantics (`mesh_from_depth.py:1866-1960`): only
    # shadows on the GROUND are interpolated, fills clamp to >= 0.1 m,
    # no NaNs are ever emitted — everything else keeps its original
    # depth. "On the ground" here means the pixel ray hits the plane in
    # front of the camera (above-horizon rays are left alone); the
    # optional ``ground_band`` additionally requires the OBSERVED point
    # to lie near the plane (the depth-space analog of the reference's
    # RANSAC-inlier ground mask — note that depth-shadow pixels carry
    # corrupt depth by definition, so a tight band can exclude exactly
    # the streaks this function exists to repair; hence opt-in).
    ground_z = ground_depth_along_rays((h, w), f_px, ground_model)
    fill = shadow & np.isfinite(ground_z)
    if ground_band is not None:
        ys, xs = np.indices((h, w))
        px = -(xs - w / 2.0) * depth / f_px
        py = -(ys - h / 2.0) * depth / f_px
        n = np.asarray(ground_model["normal"], dtype=np.float64)
        dist = px * n[0] + py * n[1] + depth * n[2] + float(ground_model["d"])
        fill &= np.abs(dist) < ground_band
    out[fill] = np.maximum(ground_z[fill], 0.1)
    return out, shadow, ground_model
