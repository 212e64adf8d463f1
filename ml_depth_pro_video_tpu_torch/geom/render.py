"""Offscreen point-cloud rendering.

Replaces the reference's Open3D OffscreenRenderer usage
(`img_to_normalized_pointcloud.py:38-223`: front/top/side/isometric
presets + a 2x2 multi-view grid) with a self-contained numpy
orthographic rasterizer: rotate into the view frame, painter-sort by
view depth, splat points with a square kernel. No GL, no display, fast
enough for per-frame video previews.

Copy of ``ml_depth_pro_video_tpu/geom/render.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from .pointcloud import PointCloud

# view presets: rotation applied to (x, y, z) before orthographic
# projection onto (u, v) = (x', y'), depth = z'
_SQ2 = np.sqrt(2.0) / 2.0


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def view_rotation(view: str) -> np.ndarray:
    if view == "front":
        return np.eye(3)
    if view == "top":
        # looking straight down with the reference's up=[0,0,-1]
        # convention (`img_to_normalized_pointcloud.py:72-77`): +X to
        # screen-right, +Z toward screen-bottom
        return _rot_x(np.radians(90))
    if view == "side":
        return _rot_y(np.radians(90))
    if view in ("iso", "isometric"):
        return _rot_x(np.radians(-30)) @ _rot_y(np.radians(45))
    raise ValueError(f"unknown view {view!r}")


def render_pointcloud_image(
    cloud: PointCloud,
    view: str = "front",
    width: int = 1280,
    height: int = 720,
    point_size: int = 2,
    background=(1.0, 1.0, 1.0),
    max_points: int | None = 500_000,
    seed: int = 0,
) -> np.ndarray:
    """Rasterize a point cloud to an (H, W, 3) uint8 image."""
    img = np.empty((height, width, 3), dtype=np.float32)
    img[:] = np.asarray(background, dtype=np.float32)
    if len(cloud) == 0:
        return (img * 255).astype(np.uint8)

    pts = cloud.points
    cols = cloud.colors if cloud.colors is not None else np.full_like(pts, 0.3)
    if max_points is not None and len(pts) > max_points:
        sel = np.random.default_rng(seed).choice(len(pts), max_points, replace=False)
        pts, cols = pts[sel], cols[sel]

    R = view_rotation(view)
    p = pts @ R.T
    u, v, depth = p[:, 0], -p[:, 1], p[:, 2]

    # fit to frame with 5% margin, preserving aspect
    u0, u1 = u.min(), u.max()
    v0, v1 = v.min(), v.max()
    span = max(u1 - u0, v1 - v0, 1e-9)
    scale = min(width, height) * 0.9 / span
    px = ((u - (u0 + u1) / 2) * scale + width / 2).astype(np.int64)
    py = ((v - (v0 + v1) / 2) * scale + height / 2).astype(np.int64)

    # z-buffered splatting: the splat-offset passes each redraw every
    # point, so without the buffer a far point's later-pass splat
    # overwrote near points drawn in earlier passes (silhouettes bled by
    # up to point_size pixels). Within a pass, the nearest duplicate per
    # pixel is selected EXPLICITLY (per-pixel argmin of depth via a
    # stable lexsort) rather than relying on fancy-index write ordering;
    # across passes the z-buffer gates the write.
    cols = cols.astype(np.float32)
    zbuf = np.full((height, width), np.inf, np.float32)
    r = max(point_size // 2, 0)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            qx = px + dx
            qy = py + dy
            ok = (qx >= 0) & (qx < width) & (qy >= 0) & (qy < height)
            qx, qy, d, c = qx[ok], qy[ok], depth[ok], cols[ok]
            lin = qy * width + qx
            by_pixel = np.lexsort((d, lin))
            lin_s = lin[by_pixel]
            first = np.ones(len(lin_s), dtype=bool)
            first[1:] = lin_s[1:] != lin_s[:-1]
            sel = by_pixel[first]  # nearest point of each touched pixel
            qx, qy, d, c = qx[sel], qy[sel], d[sel], c[sel]
            near = d < zbuf[qy, qx]
            img[qy[near], qx[near]] = c[near]
            zbuf[qy[near], qx[near]] = d[near]
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def render_multi_view(cloud: PointCloud, width: int = 1280, height: int = 720,
                      point_size: int = 2) -> np.ndarray:
    """2x2 labeled grid in the reference's tile order
    (`img_to_normalized_pointcloud.py:136-161`): TL=front, TR=top,
    BL=isometric, BR=side."""
    from PIL import Image, ImageDraw

    hw, hh = width // 2, height // 2
    tiles = []
    for v, label in (("front", "Front View"), ("top", "Top View"),
                     ("iso", "Isometric View"), ("side", "Side View")):
        tile = render_pointcloud_image(cloud, v, hw, hh, point_size)
        im = Image.fromarray(tile)
        ImageDraw.Draw(im).text((8, 6), label, fill=(0, 0, 0))
        tiles.append(np.asarray(im))
    top = np.concatenate(tiles[:2], axis=1)
    bottom = np.concatenate(tiles[2:], axis=1)
    return np.concatenate([top, bottom], axis=0)


def save_render(path: str, cloud: PointCloud, view: str = "front", **kw) -> None:
    from PIL import Image

    if view == "multi":
        img = render_multi_view(cloud, **kw)
    else:
        img = render_pointcloud_image(cloud, view=view, **kw)
    Image.fromarray(img).save(path)
