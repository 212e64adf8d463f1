"""Top-down floor-plan visualization (matplotlib Agg, headless).

Capability parity with the reference's viewers
(`pointcloud_pipeline.py:49-263` in-memory variant,
`simple_pointcloud_viewer.py:455-854`): height-threshold filtering,
X-axis flip to match the source image orientation, original-color or
height-colormap scatter, optional fitted rectangle/circle overlays with
numeric labels, fixed axis limits for video-stable framing, and shape
data export. Fixes the reference's swapped export_shape_data call
(`pointcloud_pipeline.py:253`).

Copy of ``ml_depth_pro_video_tpu/geom/floorplan_viz.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os

import numpy as np

from .pointcloud import PointCloud
from .shapes import export_shape_data, fit_shapes_to_clusters, rect_corners

try:
    from ..native import neighbors as _native
except Exception:  # pragma: no cover
    _native = None

# pyplot's implicit current-figure state machine is NOT thread-safe and
# the video pipeline renders floor plans from ThreadPoolExecutor workers
# — all pyplot sections below serialize on this lock (RLock: the shape
# artifacts are rendered from inside floorplan_visualization). The
# heavy stages (height filter, DBSCAN) stay outside the lock.
import threading

_PLOT_LOCK = threading.RLock()

_RECT_COLORS = ["#4285F4", "#34A853", "#FBBC05", "#EA4335",
                "#8E44AD", "#16A085", "#D35400", "#7F8C8D"]
_CIRC_COLORS = ["#3498DB", "#2ECC71", "#F1C40F", "#E74C3C",
                "#9B59B6", "#1ABC9C", "#E67E22", "#95A5A6"]


def _hex_to_rgb(h: str) -> np.ndarray:
    return np.array([int(h[i:i + 2], 16) / 255.0 for i in (1, 3, 5)], np.float32)


# 5x7 bitmap glyphs for the numpy rasterizer's shape labels / scale bar
_GLYPHS = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
    "m": ("00000", "00000", "11010", "10101", "10101", "10101", "10101"),
    " ": ("00000",) * 7,
}


def _draw_text(img: np.ndarray, row: int, col: int, text: str, color,
               scale: int = 2) -> None:
    """Stamp 5x7 bitmap text (digits + 'm') centered at (row, col)."""
    h, w = img.shape[:2]
    tw = len(text) * 6 * scale
    c0 = col - tw // 2
    r0 = row - 7 * scale // 2
    for ch in text:
        glyph = _GLYPHS.get(ch)
        if glyph is not None:
            for gr, bits in enumerate(glyph):
                for gc, bit in enumerate(bits):
                    if bit == "1":
                        rr = r0 + gr * scale
                        cc = c0 + gc * scale
                        img[max(rr, 0):max(min(rr + scale, h), 0),
                            max(cc, 0):max(min(cc + scale, w), 0)] = color
        c0 += 6 * scale


def _draw_polyline(img: np.ndarray, pts_px: np.ndarray, color,
                   thickness: int = 2, closed: bool = True) -> None:
    """Rasterize a polyline by dense sampling (a handful of shapes per
    frame — cost is negligible next to the point splat)."""
    h, w = img.shape[:2]
    pts_px = np.asarray(pts_px, np.float64)
    if closed:
        pts_px = np.concatenate([pts_px, pts_px[:1]])
    samples = []
    for a, b in zip(pts_px[:-1], pts_px[1:]):
        n = max(int(np.hypot(*(b - a)) * 2), 2)
        t = np.linspace(0.0, 1.0, n)[:, None]
        samples.append(a + t * (b - a))
    s = np.concatenate(samples).round().astype(np.int64)
    for dy in range(-(thickness // 2), (thickness + 1) // 2):
        for dx in range(-(thickness // 2), (thickness + 1) // 2):
            r = s[:, 1] + dy
            c = s[:, 0] + dx
            ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            img[r[ok], c[ok]] = color


def _draw_shape_overlays(img: np.ndarray, rectangles, circles,
                         x0: float, x1: float, z0: float, z1: float) -> None:
    """Rectangle/circle outlines, numeric labels, and the 1 m scale bar
    on the numpy raster — the fast-renderer equivalent of the matplotlib
    overlay section (`simple_pointcloud_viewer.py:681-786` scale bar,
    shape patches + labels)."""
    h, w = img.shape[:2]
    sx = (w - 1) / max(x1 - x0, 1e-9)
    sz = (h - 1) / max(z1 - z0, 1e-9)

    def to_px(xw, zw):
        return np.column_stack([(np.asarray(xw) - x0) * sx,
                                (z1 - np.asarray(zw)) * sz])

    for i, rect in enumerate(rectangles):
        color = _hex_to_rgb(_RECT_COLORS[i % len(_RECT_COLORS)])
        corners = np.asarray(rect_corners(rect))
        _draw_polyline(img, to_px(corners[:, 0], corners[:, 1]), color)
        ctr = to_px([rect[0]], [rect[1]])[0]
        _draw_text(img, int(ctr[1]), int(ctr[0]), str(i + 1), color)
    for i, (cx, cz, r) in enumerate(circles):
        color = _hex_to_rgb(_CIRC_COLORS[i % len(_CIRC_COLORS)])
        th = np.linspace(0, 2 * np.pi, max(int(r * sx * 4), 16))
        _draw_polyline(img, to_px(cx + r * np.cos(th), cz + r * np.sin(th)),
                       color, closed=False)
        ctr = to_px([cx], [cz])[0]
        _draw_text(img, int(ctr[1]), int(ctr[0]),
                   str(len(rectangles) + i + 1), color)

    # 1 m scale bar near the lower-left corner, labeled "1m"
    bar_px = max(int(round(sx)), 2)  # pixels per meter
    r0 = int(h * 0.95)
    c0 = int(w * 0.05)
    black = np.zeros(3, np.float32)
    img[max(r0 - 1, 0):min(r0 + 2, h), c0:min(c0 + bar_px, w)] = black
    _draw_text(img, max(r0 - 12, 0), c0 + bar_px // 2, "1m", black)


def fast_floorplan_image(
    cloud: PointCloud,
    output_path: str | None = None,
    height_threshold: float | None = None,
    width: int = 1024,
    point_radius: int = 1,
    x_limits: tuple | None = None,
    z_limits: tuple | None = None,
    background=(0.94, 0.94, 0.94),
    shapes: tuple | None = None,
) -> np.ndarray:
    """Pure-numpy top-down rasterization (~50x faster than the
    matplotlib path on this host) for video-rate floor plans. Points are
    splatted far-to-near by height so tall structure stays visible; the
    X axis is flipped to match the source image orientation.

    ``shapes=(rectangles, circles)`` additionally draws fitted-shape
    outlines, numeric labels, and the 1 m scale bar on the raster (the
    showcase-mode overlay, previously matplotlib-only)."""
    points = cloud.points
    colors = cloud.colors
    if height_threshold is not None and len(points):
        mask = points[:, 1] >= height_threshold
        points = points[mask]
        colors = colors[mask] if colors is not None else None

    # limits without materializing the flipped-x copy (min(-a) = -max(a));
    # the native splat re-negates internally, so the O(n) copy is only
    # built on the numpy fallback below
    x0, x1 = x_limits if x_limits else (
        (-points[:, 0].max(), -points[:, 0].min()) if len(points) else (0, 1))
    z0, z1 = z_limits if z_limits else (
        (points[:, 2].min(), points[:, 2].max()) if len(points) else (0, 1))
    span_x = max(x1 - x0, 1e-9)
    span_z = max(z1 - z0, 1e-9)
    height = max(int(round(width * span_z / span_x)), 1)

    img = np.empty((height, width, 3), np.float32)
    img[:] = background
    done = False
    if len(points) and _native is not None and _native.available() \
            and not np.isnan(points[:, 1]).any():
        # threaded C++ splat+dilation (native/splat.cpp): identical
        # pixels (same truncating pixel map, same stable tallest-wins
        # tie-break, same progressive 8-offset dilation order). The
        # height filter already ran above, so no threshold is passed;
        # NaN heights keep the numpy path (numpy's stable sort gives
        # NaN the win — a semantic not worth replicating in C++).
        nimg = _native.splat_floorplan(points, colors, None,
                                       (x0, x1), (z0, z1), width, height,
                                       point_radius, background)
        if nimg is not None:
            img = nimg
            done = True
    if len(points) and not done:
        x = -points[:, 0]
        z = points[:, 2]
        px = ((x - x0) / span_x * (width - 1)).astype(np.int64)
        pz = ((z1 - z) / span_z * (height - 1)).astype(np.int64)
        ok = (px >= 0) & (px < width) & (pz >= 0) & (pz < height)
        px, pz = px[ok], pz[ok]
        cols = (colors[ok] if colors is not None else np.full((int(ok.sum()), 3), 0.35)).astype(np.float32)
        ys = points[ok][:, 1]

        # ONE winner-per-pixel scatter (tallest point wins), then the
        # point radius becomes a height-aware dilation over the IMAGE —
        # 9 passes over ~1M pixels instead of 9 scatters over millions
        # of points (8 s -> ~0.5 s on a dense 2.4M-point frame).
        # stable: exact-height ties resolve to the later point in input
        # order, deterministically — and identically to the C++ splat
        # (quicksort ties were arbitrary)
        order = np.argsort(ys, kind="stable")  # low first, tall written last
        lin = pz[order] * width + px[order]
        hbuf = np.full(height * width, -np.inf, np.float32)
        hbuf[lin] = ys[order]
        img.reshape(-1, 3)[lin] = cols[order]
        hbuf = hbuf.reshape(height, width)
        r = point_radius
        if r > 0:
            src_img = img.copy()
            src_h = hbuf.copy()
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    if dy == 0 and dx == 0:
                        continue
                    sh = np.full_like(src_h, -np.inf)
                    ys0, ys1 = max(dy, 0), height + min(dy, 0)
                    xs0, xs1 = max(dx, 0), width + min(dx, 0)
                    sh[ys0:ys1, xs0:xs1] = src_h[ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
                    win = sh > hbuf
                    if win.any():
                        img[win] = np.roll(np.roll(src_img, dy, 0), dx, 1)[win]
                        hbuf[win] = sh[win]
    if shapes is not None:
        _draw_shape_overlays(img, shapes[0], shapes[1], x0, x1, z0, z1)
    out = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if output_path:
        from PIL import Image

        Image.fromarray(out).save(output_path)
    return out


def fast_floorplan_visualization(
    cloud: PointCloud,
    output_path: str,
    height_threshold: float | None = None,
    width: int = 1024,
    fit_shapes: bool = False,
    cluster_eps: float = 0.2,
    min_cluster_size: int = 5,
    circularity_threshold: float = 0.85,
    output_all_files: bool = True,
    x_limits: tuple | None = None,
    z_limits: tuple | None = None,
    dpi: int = 150,
    seed: int = 0,
):
    """Showcase-mode floor plan at video rate: DBSCAN shape fitting +
    the numpy rasterizer with shape overlays for the main scatter frame;
    matplotlib is used ONLY for the two golden-format artifacts
    (_shapes.png / _floor_plan.png) and only when ``output_all_files``
    demands them. Returns (rectangles, circles) like
    ``floorplan_visualization``."""
    # filter once; every stage below reuses the thresholded cloud
    if height_threshold is not None and len(cloud.points):
        fcloud = cloud.select(cloud.points[:, 1] >= height_threshold)
    else:
        fcloud = cloud
    pts = fcloud.points

    rectangles, circles = [], []
    if fit_shapes and len(pts):
        shape_points = np.column_stack([-pts[:, 0], pts[:, 2]])
        if len(shape_points) > 100_000:
            rng = np.random.default_rng(seed)
            shape_points = shape_points[
                rng.choice(len(shape_points), 100_000, replace=False)]
        if len(shape_points) >= min_cluster_size:
            rectangles, circles = fit_shapes_to_clusters(
                shape_points, eps=cluster_eps, min_samples=min_cluster_size,
                circularity_threshold=circularity_threshold,
            )
    fast_floorplan_image(
        fcloud, output_path, height_threshold=None, width=width,
        x_limits=x_limits, z_limits=z_limits,
        shapes=(rectangles, circles) if fit_shapes else None,
    )
    if fit_shapes and output_all_files:
        base = os.path.splitext(output_path)[0]
        export_shape_data(rectangles, circles, base + "_shapes.txt")
        if x_limits is None or z_limits is None:
            if len(pts):
                x_limits = x_limits or (float(-pts[:, 0].max()), float(-pts[:, 0].min()))
                z_limits = z_limits or (float(pts[:, 2].min()), float(pts[:, 2].max()))
            else:
                x_limits, z_limits = x_limits or (0, 1), z_limits or (0, 1)
        lim = dict(x_limits=x_limits, z_limits=z_limits, dpi=dpi)
        shapes_only_plan(rectangles, circles, base + "_shapes.png", **lim)
        filled_floor_plan(rectangles, circles, base + "_floor_plan.png", **lim)
    return rectangles, circles


def floorplan_visualization(
    cloud: PointCloud,
    output_path: str,
    height_threshold: float | None = None,
    point_size: float = 2,
    dpi: int = 150,
    max_points: int = 50_000,
    fit_shapes: bool = False,
    cluster_eps: float = 0.2,
    min_cluster_size: int = 5,
    circularity_threshold: float = 0.85,
    output_all_files: bool = True,
    x_limits: tuple | None = None,
    z_limits: tuple | None = None,
    seed: int = 0,
):
    """Render a top-down floor plan PNG; returns (rectangles, circles)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    points = cloud.points
    colors = cloud.colors

    if height_threshold is not None and len(points):
        mask = points[:, 1] >= height_threshold
        points = points[mask]
        colors = colors[mask] if colors is not None else None

    if len(points) < max(min_cluster_size, 1):
        # nothing above the threshold: emit a blank frame so video
        # sequences stay continuous (+ the empty shape artifacts, so a
        # fit_shapes run always produces the full file set)
        _PLOT_LOCK.acquire()
        fig = plt.figure(figsize=(12, 12))
        try:
            plt.axis("off")
            plt.gca().set_facecolor("#f0f0f0")
            plt.xlim(*(x_limits or (0, 1)))
            plt.ylim(*(z_limits or (0, 1)))
            plt.savefig(output_path, dpi=dpi, bbox_inches="tight", pad_inches=0)
        finally:
            plt.close(fig)
            _PLOT_LOCK.release()
        if fit_shapes and output_all_files:
            base = os.path.splitext(output_path)[0]
            export_shape_data([], [], base + "_shapes.txt")
            lim = dict(x_limits=x_limits or (0, 1), z_limits=z_limits or (0, 1), dpi=dpi)
            shapes_only_plan([], [], base + "_shapes.png", **lim)
            filled_floor_plan([], [], base + "_floor_plan.png", **lim)
        return [], []

    # top-down (X flipped to match the source image orientation)
    x = -points[:, 0]
    z = points[:, 2]
    points_2d = np.column_stack([x, z])

    rectangles, circles = [], []
    if fit_shapes:
        shape_points = points_2d
        if len(shape_points) > 100_000:
            shape_points = shape_points[rng.choice(len(shape_points), 100_000, replace=False)]
        rectangles, circles = fit_shapes_to_clusters(
            shape_points, eps=cluster_eps, min_samples=min_cluster_size,
            circularity_threshold=circularity_threshold,
        )

    if len(points) > max_points:
        sel = rng.choice(len(points), max_points, replace=False)
        x, z = x[sel], z[sel]
        heights = points[sel, 1]
        colors = colors[sel] if colors is not None else None
    else:
        heights = points[:, 1]

    _PLOT_LOCK.acquire()
    fig = plt.figure(figsize=(12, 12))
    try:
        alpha = 0.5 if fit_shapes else 0.8
        if colors is not None and len(colors):
            rgba = np.concatenate([colors, np.full((len(colors), 1), alpha)], axis=1)
            plt.scatter(x, z, s=point_size, c=rgba)
        else:
            plt.scatter(x, z, s=point_size, c=heights, cmap="jet", alpha=alpha)

        ax = plt.gca()
        for i, rect in enumerate(rectangles):
            corners = rect_corners(rect)
            ax.add_patch(
                plt.Polygon(corners, closed=True, fill=False, linewidth=2,
                            edgecolor=_RECT_COLORS[i % len(_RECT_COLORS)], alpha=0.9)
            )
            plt.text(rect[0], rect[1], str(i + 1), ha="center", va="center",
                     color=_RECT_COLORS[i % len(_RECT_COLORS)], fontsize=10,
                     fontweight="bold",
                     bbox=dict(facecolor="white", alpha=0.7, edgecolor="none"))
        for i, (cx, cy, r) in enumerate(circles):
            ax.add_patch(
                plt.Circle((cx, cy), r, fill=False, linewidth=2,
                           edgecolor=_CIRC_COLORS[i % len(_CIRC_COLORS)], alpha=0.9)
            )
            plt.text(cx, cy, str(len(rectangles) + i + 1), ha="center", va="center",
                     color=_CIRC_COLORS[i % len(_CIRC_COLORS)], fontsize=10,
                     fontweight="bold",
                     bbox=dict(facecolor="white", alpha=0.7, edgecolor="none"))

        plt.axis("equal")
        plt.axis("off")
        ax.set_facecolor("#f0f0f0")
        # fixed limits give video-stable framing; else exact data bounds
        plt.xlim(*(x_limits if x_limits else (x.min(), x.max())))
        plt.ylim(*(z_limits if z_limits else (z.min(), z.max())))
        plt.savefig(output_path, dpi=dpi, bbox_inches="tight", pad_inches=0)
    finally:
        plt.close(fig)
        _PLOT_LOCK.release()

    if fit_shapes and output_all_files:
        base = os.path.splitext(output_path)[0]
        export_shape_data(rectangles, circles, base + "_shapes.txt")
        lim = dict(
            x_limits=x_limits or (float(x.min()), float(x.max())),
            z_limits=z_limits or (float(z.min()), float(z.max())),
            dpi=dpi,
        )
        shapes_only_plan(rectangles, circles, base + "_shapes.png", **lim)
        filled_floor_plan(rectangles, circles, base + "_floor_plan.png", **lim)
    return rectangles, circles


def shapes_only_plan(
    rectangles, circles, output_path: str,
    x_limits: tuple | None = None, z_limits: tuple | None = None,
    dpi: int = 150,
):
    """Clean floor plan of just the fitted shapes with a 1 m scale bar
    (`simple_pointcloud_viewer.py:681-786`): colored patches, numeric
    labels, dimension text on large shapes, total-area title."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    _PLOT_LOCK.acquire()
    fig = plt.figure(figsize=(12, 12))
    try:
        ax = plt.gca()
        for i, rect in enumerate(rectangles):
            cx, cy, w, h, ang = rect
            ax.add_patch(
                plt.Polygon(rect_corners(rect), closed=True, linewidth=2,
                            edgecolor="black",
                            facecolor=_RECT_COLORS[i % len(_RECT_COLORS)], alpha=0.7)
            )
            plt.text(cx, cy, str(i + 1), ha="center", va="center",
                     color="white", fontsize=10, fontweight="bold")
            if w > 0.3 and h > 0.3:
                plt.text(cx, cy + 0.15, f"{w:.2f}×{h:.2f}m",
                         ha="center", va="center", color="white", fontsize=8)
        for i, (cx, cy, r) in enumerate(circles):
            ax.add_patch(
                patches.Circle((cx, cy), r, linewidth=2, edgecolor="black",
                               facecolor=_CIRC_COLORS[i % len(_CIRC_COLORS)], alpha=0.7)
            )
            plt.text(cx, cy, str(len(rectangles) + i + 1), ha="center",
                     va="center", color="white", fontsize=10, fontweight="bold")
            if r > 0.2:
                plt.text(cx, cy + 0.1, f"r={r:.2f}m", ha="center", va="center",
                         color="white", fontsize=8)

        total = (sum(r[2] * r[3] for r in rectangles)
                 + sum(np.pi * c[2] ** 2 for c in circles))
        plt.title(f"Floor Plan - {len(rectangles)} Rectangles, "
                  f"{len(circles)} Circles (Total Area: {total:.2f}m²)")
        plt.xlabel("X (meters)")
        plt.ylabel("Z (meters)")
        plt.axis("equal")
        plt.grid(True, linestyle="--", alpha=0.4)
        ax.set_facecolor("#f8f9fa")
        if x_limits:
            plt.xlim(*x_limits)
        if z_limits:
            plt.ylim(*z_limits)

        # 1 m scale bar near the lower-left corner
        xl, zl = plt.xlim(), plt.ylim()
        bar_x = xl[0] + 0.1 * (xl[1] - xl[0])
        bar_y = zl[0] + 0.1 * (zl[1] - zl[0])
        plt.plot([bar_x, bar_x + 1.0], [bar_y, bar_y], "k-", linewidth=3)
        plt.text(bar_x + 0.5, bar_y - 0.1, "1 meter", ha="center", va="top")

        plt.tight_layout()
        plt.savefig(output_path, dpi=dpi)
    finally:
        plt.close(fig)
        _PLOT_LOCK.release()


def filled_floor_plan(
    rectangles, circles, output_path: str,
    x_limits: tuple | None = None, z_limits: tuple | None = None,
    dpi: int = 150,
):
    """Simplified floor plan with solid light-gray fills, axes off
    (`simple_pointcloud_viewer.py:788-846`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    _PLOT_LOCK.acquire()
    fig, ax = plt.subplots(figsize=(12, 12), facecolor="white")
    try:
        ax.set_facecolor("white")
        for rect in rectangles:
            ax.add_patch(
                plt.Polygon(rect_corners(rect), closed=True, linewidth=1.5,
                            edgecolor="black", facecolor="lightgray", alpha=1.0)
            )
        for cx, cy, r in circles:
            ax.add_patch(
                patches.Circle((cx, cy), r, linewidth=1.5, edgecolor="black",
                               facecolor="lightgray", alpha=1.0)
            )
        plt.axis("equal")
        plt.axis("off")
        if x_limits:
            plt.xlim(*x_limits)
        if z_limits:
            plt.ylim(*z_limits)
        plt.tight_layout()
        plt.savefig(output_path, dpi=dpi, bbox_inches="tight", pad_inches=0.1)
    finally:
        plt.close(fig)
        _PLOT_LOCK.release()
