"""2-D shape fitting for floor plans: clusters -> rectangles / circles.

Capability parity with the reference's `simple_pointcloud_viewer.py:12-453`
(DBSCAN clustering, min-area rectangle vs least-squares circle
arbitration via convex-hull circularity, forced splitting of huge
rectangles, L-shape detection through occupancy-grid empty-region
analysis, shape export). Implementation differences, by design:

- min-area rectangle is our own rotating-calipers over the convex hull
  (no OpenCV dependency in the geometry core);
- connected components / dilation use scipy.ndimage instead of cv2;
- point-in-rectangle tests are a vectorized inverse-rotation instead of
  shapely per-point ``contains`` loops;
- ``export_shape_data`` takes (rectangles, circles, output_path) — the
  reference pipeline calls it with swapped arguments
  (`pointcloud_pipeline.py:253`), a bug we fix rather than replicate.

Rectangles are (center_x, center_y, width, height, angle_deg);
circles are (center_x, center_y, radius). Units: meters.

Copy of ``ml_depth_pro_video_tpu/geom/shapes.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# primitives


def min_area_rect(points: np.ndarray):
    """Minimum-area enclosing rectangle via rotating calipers.

    Returns (center_x, center_y, width, height, angle_deg) with the
    rectangle's first axis at ``angle_deg`` from +x.
    """
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 1:
        return (pts[0, 0], pts[0, 1], 0.0, 0.0, 0.0)
    uniq = np.unique(pts, axis=0)
    if len(uniq) < 3 or np.linalg.matrix_rank(uniq - uniq.mean(0)) < 2:
        # degenerate: collinear points -> zero-height rect along the span
        d = uniq - uniq.mean(0)
        direction = d[np.argmax(np.linalg.norm(d, axis=1))]
        ang = np.degrees(np.arctan2(direction[1], direction[0]))
        proj = d @ (direction / (np.linalg.norm(direction) + 1e-12))
        c = uniq.mean(0)
        return (c[0], c[1], float(proj.max() - proj.min()), 0.0, float(ang % 180))

    hull = pts[ConvexHull(pts).vertices]
    edges = np.roll(hull, -1, axis=0) - hull
    angles = np.arctan2(edges[:, 1], edges[:, 0])
    cos, sin = np.cos(-angles), np.sin(-angles)
    # rotate hull by each edge angle: (E, H, 2)
    rx = cos[:, None] * hull[None, :, 0] - sin[:, None] * hull[None, :, 1]
    ry = sin[:, None] * hull[None, :, 0] + cos[:, None] * hull[None, :, 1]
    w = rx.max(1) - rx.min(1)
    h = ry.max(1) - ry.min(1)
    areas = w * h
    i = int(np.argmin(areas))
    cx_r = (rx[i].max() + rx[i].min()) / 2
    cy_r = (ry[i].max() + ry[i].min()) / 2
    # rotate center back
    ca, sa = np.cos(angles[i]), np.sin(angles[i])
    cx = ca * cx_r - sa * cy_r
    cy = sa * cx_r + ca * cy_r
    return (float(cx), float(cy), float(w[i]), float(h[i]), float(np.degrees(angles[i]) % 180))


def rect_corners(rect) -> np.ndarray:
    """(4, 2) corner coordinates of a (cx, cy, w, h, angle_deg) rect."""
    cx, cy, w, h, ang = rect
    a = np.radians(ang)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    local = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2.0
    return local @ R.T + np.array([cx, cy])


def points_in_rect(points: np.ndarray, rect, margin: float = 0.0) -> np.ndarray:
    """Vectorized point-in-rotated-rectangle mask."""
    cx, cy, w, h, ang = rect
    a = np.radians(-ang)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    local = (np.asarray(points) - [cx, cy]) @ R.T
    return (np.abs(local[:, 0]) <= w / 2 + margin) & (np.abs(local[:, 1]) <= h / 2 + margin)


def fit_circle(points: np.ndarray):
    """Least-squares circle fit (same formulation as the reference:
    minimize radial residuals around the mean radius)."""
    from scipy import optimize

    pts = np.asarray(points, dtype=np.float64)

    def radii(c):
        return np.hypot(pts[:, 0] - c[0], pts[:, 1] - c[1])

    def resid(c):
        r = radii(c)
        return r - r.mean()

    center, _ = optimize.leastsq(resid, pts.mean(axis=0))
    r = radii(center).mean()
    return float(center[0]), float(center[1]), float(r)


def is_better_fit_as_circle(points, rect_area, circle_area, circle_fit_error,
                            circularity_threshold: float = 0.85) -> bool:
    """Convex-hull circularity arbitration (`simple_pointcloud_viewer.py:44-77`)."""
    try:
        from scipy.spatial import ConvexHull

        hull_area = ConvexHull(points).volume
        circularity = hull_area / circle_area
        circularity = min(circularity, 1.0 / circularity)
        return (
            circularity > circularity_threshold
            and circle_fit_error < 0.15
            and abs(circle_area - rect_area) / max(circle_area, rect_area) < 0.3
        )
    except Exception:
        return (
            circle_fit_error < 0.1
            and abs(circle_area - rect_area) / max(circle_area, rect_area) < 0.2
        )


# ---------------------------------------------------------------------------
# splitting


def split_large_rectangle(rect):
    """Halve an oversized rectangle along its longer side."""
    cx, cy, w, h, ang = rect
    a = np.radians(ang)
    if w > h:
        off = np.array([np.cos(a), np.sin(a)]) * (w / 4)
        return [
            (cx - off[0], cy - off[1], w / 2, h, ang),
            (cx + off[0], cy + off[1], w / 2, h, ang),
        ]
    off = np.array([-np.sin(a), np.cos(a)]) * (h / 4)
    return [
        (cx + off[0], cy + off[1], w, h / 2, ang),
        (cx - off[0], cy - off[1], w, h / 2, ang),
    ]


def detect_and_split_l_shapes(rectangles, points_2d, grid_size: float = 0.2,
                              min_area: float = 10.0):
    """Split L-shaped rectangles using occupancy-grid empty-region
    analysis (`simple_pointcloud_viewer.py:79-282`)."""
    from scipy import ndimage

    points_2d = np.asarray(points_2d)
    out = []
    for rect in rectangles:
        cx, cy, w, h, ang = rect
        if w * h < min_area:
            out.append(rect)
            continue
        inside = points_in_rect(points_2d, rect)
        cluster = points_2d[inside]
        if len(cluster) < 50:
            out.append(rect)
            continue

        a = np.radians(-ang)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        local = (cluster - [cx, cy]) @ R.T

        gw = int(w / grid_size) + 1
        gh = int(h / grid_size) + 1
        if gw <= 2 or gh <= 2:
            out.append(rect)
            continue
        gx = ((local[:, 0] + w / 2) / grid_size).astype(int)
        gy = ((local[:, 1] + h / 2) / grid_size).astype(int)
        ok = (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
        occ = np.zeros((gh, gw), dtype=bool)
        occ[gy[ok], gx[ok]] = True
        occ = ndimage.binary_dilation(occ, structure=np.ones((2, 2), bool))

        empty = ~occ
        labels, n_lab = ndimage.label(empty, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
        sizes = ndimage.sum_labels(np.ones_like(labels), labels, index=range(1, n_lab + 1))
        significant = [i + 1 for i, s in enumerate(sizes) if s >= 6]
        if not significant:
            out.append(rect)
            continue
        empty_mask = np.isin(labels, significant)
        empty_ratio = empty_mask.mean()
        if not (0.2 <= empty_ratio <= 0.6):
            out.append(rect)
            continue

        occupied = ~empty_mask
        occ_labels, n_occ = ndimage.label(occupied, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
        if n_occ < 2:
            out.append(rect)
            continue

        subs = []
        for i in range(1, n_occ + 1):
            ys, xs = np.nonzero(occ_labels == i)
            if len(ys) < 6:
                continue
            rpts = np.column_stack([xs * grid_size - w / 2, ys * grid_size - h / 2])
            if len(rpts) < 4:
                continue
            sub = min_area_rect(rpts)
            # back to world coords with the TRUE inverse rotation —
            # deliberate fix of a reference bug (the fourth sanctioned
            # one, CLAUDE.md): `simple_pointcloud_viewer.py:253-256`
            # applies the forward rotation R(-ang) a second time, which
            # mirrors sub-rectangle placements for tilted rectangles
            scx, scy = np.array([sub[0], sub[1]]) @ R + np.array([cx, cy])
            sub_rect = (float(scx), float(scy), sub[2], sub[3], (sub[4] + ang) % 180)
            if sub[2] * sub[3] > 1.0:
                subs.append(sub_rect)
        if len(subs) >= 2:
            sub_area = sum(s[2] * s[3] for s in subs)
            if 0.4 < sub_area / (w * h) < 1.3:
                out.extend(subs)
                continue
        out.append(rect)
    return out


# ---------------------------------------------------------------------------
# clustering + export


def _dbscan_labels(points_2d: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN with a grid dedup front-end: points are aggregated to
    (eps/4)-cell representatives (their mean) and the representatives are
    clustered with ``sample_weight`` = cell population, which preserves
    DBSCAN's core-point counting; labels propagate back through the cell
    map. Bounds the O(n * neighbors) DBSCAN cost by the OCCUPIED AREA
    instead of the point count — dense 100k-point blobs (every frame of
    a video run) collapse to a few thousand cells, where the plain call
    built multi-GB neighbor graphs and took tens of seconds."""
    from sklearn.cluster import DBSCAN

    cell = np.floor(points_2d / (eps / 4.0)).astype(np.int64)
    cell -= cell.min(axis=0)
    key = cell[:, 0] * (cell[:, 1].max() + 1) + cell[:, 1]  # 1-D unique >> axis=0
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    reps = np.zeros((len(uniq), 2))
    np.add.at(reps, inv, points_2d)
    reps /= counts[:, None]
    cell_labels = DBSCAN(eps=eps, min_samples=min_samples).fit(
        reps, sample_weight=counts
    ).labels_
    return cell_labels[inv]


def fit_shapes_to_clusters(points_2d: np.ndarray, eps: float = 0.2,
                           min_samples: int = 5,
                           circularity_threshold: float = 0.85):
    """DBSCAN clusters -> fitted rectangles + circles."""
    points_2d = np.asarray(points_2d, dtype=np.float64)
    labels = _dbscan_labels(points_2d, eps, min_samples)

    rectangles, circles = [], []
    for cid in range(labels.max() + 1):
        cluster = points_2d[labels == cid]
        if len(cluster) < 5:
            continue
        rect = min_area_rect(cluster)
        rect_area = rect[2] * rect[3]
        use_circle = False
        try:
            xc, yc, r = fit_circle(cluster)
            circle_area = np.pi * r * r
            dist = np.hypot(cluster[:, 0] - xc, cluster[:, 1] - yc)
            err = float(np.mean((dist - r) ** 2) / (r * r))
            use_circle = is_better_fit_as_circle(
                cluster, rect_area, circle_area, err, circularity_threshold
            )
        except Exception:
            pass
        if use_circle:
            circles.append((xc, yc, r))
        elif rect_area > 100 and len(cluster) > 1000:
            rectangles.extend(split_large_rectangle(rect))
        else:
            rectangles.append(rect)

    rectangles = detect_and_split_l_shapes(rectangles, points_2d)
    return rectangles, circles


def export_shape_data(rectangles, circles, output_path: str) -> None:
    """Write the shape summary text file (format parity with the
    reference export, `simple_pointcloud_viewer.py:414-453`)."""
    total_rect = sum(r[2] * r[3] for r in rectangles)
    total_circ = sum(np.pi * c[2] ** 2 for c in circles)
    with open(output_path, "w") as f:
        f.write("# Floor Plan Shape Data\n# Units: meters\n\n")
        f.write(f"Total Shapes: {len(rectangles) + len(circles)}\n")
        f.write(f"Rectangles: {len(rectangles)}\n")
        f.write(f"Circles: {len(circles)}\n\n")
        f.write(f"Total Area: {total_rect + total_circ:.2f} square meters\n\n")
        f.write("# Rectangles\n")
        f.write("# Format: ID, center_x, center_y, width, height, angle_degrees, area_m2\n")
        for i, (cx, cy, w, h, ang) in enumerate(rectangles):
            f.write(f"{i+1}, {cx:.3f}, {cy:.3f}, {w:.3f}, {h:.3f}, {ang:.1f}, {w*h:.3f}\n")
        f.write("\n# Circles\n")
        f.write("# Format: ID, center_x, center_y, radius, area_m2\n")
        for i, (cx, cy, r) in enumerate(circles):
            f.write(f"{len(rectangles)+i+1}, {cx:.3f}, {cy:.3f}, {r:.3f}, {np.pi*r*r:.3f}\n")
