"""Standalone floor plans from cleaned point clouds (PLY -> plans).

Capability parity with the reference's `cleaned_pointcloud_to_floorplan.py`
(RANSAC floor detection `:39-88`, floor normalization `:90-116`, height
slices `:118-170`, per-slice density grid -> morphological close/open ->
contours -> simplified polygons with rectangle snap `:245-430`, viridis
height-colored plan `:432-598`, polygon data export `:600-626`, simple
scatter `:628-674`, direct occupancy floorplan with max-height coloring
and 1 m scale bar `:676-886`, 4-output orchestrator `:888-1053`).

shapely is replaced by a minimal polygon type (shoelace area, affine
transform); morphology/contours use cv2 as the reference does; the
plane RANSAC is seeded and vectorized.

Copy of ``ml_depth_pro_video_tpu/geom/floorplan.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .ground import rotation_between
from .pointcloud import PointCloud


# ---------------------------------------------------------------------------
# minimal polygon (shapely replacement)


@dataclasses.dataclass
class Polygon2D:
    exterior: np.ndarray  # (N, 2), open ring

    @property
    def area(self) -> float:
        x, y = self.exterior[:, 0], self.exterior[:, 1]
        return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    @property
    def bounds(self):
        return (*self.exterior.min(0), *self.exterior.max(0))

    @property
    def centroid(self) -> np.ndarray:
        return self.exterior.mean(axis=0)

    def transform(self, scale: float = 1.0, offset=(0.0, 0.0)) -> "Polygon2D":
        return Polygon2D(self.exterior * scale + np.asarray(offset))


# ---------------------------------------------------------------------------
# floor detection / normalization


def detect_floor_plane(cloud: PointCloud, distance_threshold: float = 0.02,
                       ransac_n: int = 3, num_iterations: int = 1000,
                       seed: int = 0):
    """Seeded 3-point plane RANSAC (Open3D segment_plane replacement).

    Returns ((a, b, c, d), inlier_indices) with ax+by+cz+d=0."""
    pts = cloud.points
    n = len(pts)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(num_iterations, ransac_n))
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    normals = np.cross(p1 - p0, p2 - p0)
    norms = np.linalg.norm(normals, axis=1)
    ok = norms > 1e-12
    normals[ok] /= norms[ok, None]
    d = -np.einsum("ij,ij->i", normals, p0)
    # score candidate planes in chunks: the full (N, I) distance matrix
    # is ~8 GB float64 at 1M points x 1000 iterations
    counts = np.empty(num_iterations, np.int64)
    chunk = max(1, int(5e7 // max(n, 1)))
    for i in range(0, num_iterations, chunk):
        dist = np.abs(pts @ normals[i:i + chunk].T + d[i:i + chunk])
        counts[i:i + chunk] = (dist < distance_threshold).sum(axis=0)
    counts[~ok] = -1
    best = int(np.argmax(counts))
    best_dist = np.abs(pts @ normals[best] + d[best])
    inliers = np.nonzero(best_dist < distance_threshold)[0]
    a, b, c = normals[best]
    return (float(a), float(b), float(c), float(d[best])), inliers


def normalize_points_to_floor(points: np.ndarray, floor_model) -> np.ndarray:
    """Rotate the detected floor normal to +Y and translate floor to y=0.

    Deliberate fix of a reference bug (the third sanctioned one, see
    CLAUDE.md): `cleaned_pointcloud_to_floorplan.py:108-114` subtracts
    ``outer(distances, normal)`` — that PROJECTS every point onto the
    floor plane, collapsing all above-floor structure, after which the
    height slices select points by the tilted plane's own y-variation.
    A rigid rotation + translation is the operation the docstring there
    describes ("floor points have y=0 and everything else relative to
    the floor")."""
    a, b, c, d = floor_model
    normal = np.array([a, b, c], dtype=np.float64)
    if normal[1] < 0:
        normal, d = -normal, -d
    R = rotation_between(normal, np.array([0.0, 1.0, 0.0]))
    out = np.asarray(points) @ R.T
    # plane point distance d maps to y offset after rotation
    out[:, 1] += d / np.linalg.norm(normal)
    return out


# ---------------------------------------------------------------------------
# slices and grids


def create_height_slices(points: np.ndarray, colors: np.ndarray | None,
                         height_min: float = 0.1, height_max: float = 2.5,
                         num_slices: int = 5, height_threshold: float | None = None):
    """Split points into height bands; single band above threshold when
    ``height_threshold`` is given."""
    slices = []
    if height_threshold is not None:
        mask = points[:, 1] >= height_threshold
        sel = points[mask]
        # the slice is labeled with the MEAN height of its points, not
        # the threshold (`cleaned_pointcloud_to_floorplan.py:143`)
        label = float(np.mean(sel[:, 1])) if len(sel) else float(height_threshold)
        slices.append({
            "points": sel,
            "colors": colors[mask] if colors is not None else None,
            "height": label,
        })
        return slices
    edges = np.linspace(height_min, height_max, num_slices + 1)
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (points[:, 1] >= lo) & (points[:, 1] < hi)
        slices.append({
            "points": points[mask],
            "colors": colors[mask] if colors is not None else None,
            "height": float((lo + hi) / 2),
        })
    return slices


def create_density_grid(points_2d: np.ndarray, grid_resolution: float = 0.05,
                        padding: float = 1.0, weights: np.ndarray | None = None):
    """2-D histogram grid; returns (grid, (min_x, min_z), resolution)."""
    if len(points_2d) == 0:
        return np.zeros((1, 1), np.float32), (0.0, 0.0), grid_resolution
    min_x, min_z = points_2d.min(axis=0) - padding
    max_x, max_z = points_2d.max(axis=0) + padding
    nx = max(int(np.ceil((max_x - min_x) / grid_resolution)), 1)
    nz = max(int(np.ceil((max_z - min_z) / grid_resolution)), 1)
    xi = np.clip(((points_2d[:, 0] - min_x) / grid_resolution).astype(int), 0, nx - 1)
    zi = np.clip(((points_2d[:, 1] - min_z) / grid_resolution).astype(int), 0, nz - 1)
    grid = np.zeros((nz, nx), np.float32)
    np.add.at(grid, (zi, xi), 1.0 if weights is None else weights)
    return grid, (float(min_x), float(min_z)), grid_resolution


def optimal_closing_kernel(grid: np.ndarray) -> int:
    """Adaptive odd kernel size from grid occupancy (denser grid ->
    smaller kernel), mirroring the reference heuristic (`:214-243`)."""
    occ = (grid > 0).mean()
    if occ > 0.3:
        k = 3
    elif occ > 0.1:
        k = 5
    elif occ > 0.03:
        k = 7
    else:
        k = 9
    return k


def process_height_slice(points_slice: np.ndarray, avg_height: float,
                         grid_resolution: float = 0.05, min_points: int = 10,
                         padding: float = 0.5, height_threshold: float | None = None):
    """Density grid -> binary -> morphological close/open -> contours."""
    import cv2

    if len(points_slice) < min_points:
        return None
    pts2d = points_slice[:, [0, 2]]
    grid, origin, res = create_density_grid(pts2d, grid_resolution, padding)
    binary = (grid > 0).astype(np.uint8)
    if height_threshold is not None:
        # threshold mode: aggressive closing (reference `:286-306`)
        kernel = np.ones((7, 7), np.uint8)
        processed = cv2.morphologyEx(binary, cv2.MORPH_CLOSE, kernel, iterations=2)
    else:
        k = optimal_closing_kernel(grid)
        processed = cv2.morphologyEx(binary, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))
    processed = cv2.morphologyEx(processed, cv2.MORPH_OPEN, np.ones((3, 3), np.uint8))
    contours, _ = cv2.findContours(processed, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return processed, contours, origin, res


def contour_to_polygon(contour, grid_origin, grid_resolution: float,
                       min_area: float = 0.05, simplify: bool = True,
                       height_threshold: float | None = None) -> Polygon2D | None:
    """Simplify (Douglas-Peucker), convert to world meters, snap nearly
    rectangular outlines to their min-area rectangle (`:314-430`).

    Threshold mode mirrors the reference's adaptations (`:336,:347`):
    min_area/4 (on top of the orchestrator's /4 — effectively /16 of the
    default) and half the simplification epsilon."""
    import cv2

    alpha = 0.01
    if height_threshold is not None:
        min_area = min_area / 4
        alpha = alpha / 2
    area_cells = cv2.contourArea(contour)
    if area_cells * grid_resolution**2 < min_area:
        return None
    pts = contour
    if simplify:
        eps = alpha * cv2.arcLength(contour, True)
        pts = cv2.approxPolyDP(contour, eps, True)
    ring = pts.reshape(-1, 2).astype(np.float64)
    if len(ring) < 3:
        return None
    # rectangle snap only for 4-6-vertex simplified outlines whose area
    # is within 20% of their min-area rect (`:372-385`)
    if 4 <= len(ring) <= 6:
        hull = cv2.convexHull(ring.astype(np.float32))
        rect = cv2.minAreaRect(hull)
        rect_area = rect[1][0] * rect[1][1]
        poly_area = _ring_area(ring)
        if poly_area > 0 and abs(rect_area - poly_area) / poly_area < 0.2:
            ring = cv2.boxPoints(rect).astype(np.float64)
    world = ring * grid_resolution + np.asarray(grid_origin)
    return Polygon2D(world)


def _ring_area(ring: np.ndarray) -> float:
    x, z = ring[:, 0], ring[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(z, -1)) - np.dot(z, np.roll(x, -1))))


def create_colored_height_map(slices, grid_resolution: float = 0.05,
                              min_area: float = 0.1,
                              height_threshold: float | None = None):
    """All slices -> list of (Polygon2D, height) pairs (`:432-500`).

    Threshold mode uses a 2x coarser grid (connects sparse elevated
    points) and min_area/4, mirroring the orchestrator's adaptations
    (`cleaned_pointcloud_to_floorplan.py:1008-1019`)."""
    if height_threshold is not None:
        grid_resolution = grid_resolution * 2
        min_area = min_area / 4
    polygons = []
    for sl in slices:
        out = process_height_slice(sl["points"], sl["height"], grid_resolution,
                                   height_threshold=height_threshold)
        if out is None:
            continue
        _, contours, origin, res = out
        for contour in contours:
            poly = contour_to_polygon(contour, origin, res, min_area,
                                      height_threshold=height_threshold)
            if poly is not None:
                polygons.append((poly, sl["height"]))
    return polygons


# ---------------------------------------------------------------------------
# plotting / export


def plot_floorplan(polygons, output_path: str, height_min: float = 0.1,
                   height_max: float = 2.5, dpi: int = 150) -> None:
    """Viridis height-colored polygon floor plan with colorbar (`:502-598`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm, colors as mcolors

    fig, ax = plt.subplots(figsize=(12, 12))
    try:
        norm = mcolors.Normalize(vmin=height_min, vmax=height_max)
        cmap = matplotlib.colormaps["viridis"]
        for poly, height in polygons:
            ax.add_patch(plt.Polygon(poly.exterior, closed=True,
                                     facecolor=cmap(norm(height)), alpha=0.6,
                                     edgecolor="black", linewidth=0.5))
        if polygons:
            allpts = np.vstack([p.exterior for p, _ in polygons])
            ax.set_xlim(allpts[:, 0].min() - 0.5, allpts[:, 0].max() + 0.5)
            ax.set_ylim(allpts[:, 1].min() - 0.5, allpts[:, 1].max() + 0.5)
        ax.set_aspect("equal")
        sm = cm.ScalarMappable(norm=norm, cmap=cmap)
        fig.colorbar(sm, ax=ax, label="Height (m)")
        ax.set_title(f"Floor plan ({len(polygons)} regions)")
        fig.savefig(output_path, dpi=dpi, bbox_inches="tight")
    finally:
        plt.close(fig)


def save_floorplan_data(polygons, output_path: str) -> None:
    """Polygon txt export, byte-format parity with the reference writer
    (`:600-626` and the checked-in `output_0243_clean_floorplan.txt`):
    comma-separated ``height, num_points, x1, z1, x2, z2, ...`` lines
    sorted by height."""
    with open(output_path, "w") as f:
        f.write("# Floor Plan Data\n")
        f.write("# Units: meters\n\n")
        f.write("# Shapes by height\n")
        f.write("# Format: height, num_points, x1, z1, x2, z2, ...\n")
        for poly, height in sorted(polygons, key=lambda x: x[1]):
            coords = np.asarray(poly.exterior)
            f.write(f"{height:.3f}, {len(coords)}")
            for x, z in coords:
                f.write(f", {x:.3f}, {z:.3f}")
            f.write("\n")


def create_simple_point_visualization(points: np.ndarray, output_path: str,
                                      height_threshold: float | None = None,
                                      dpi: int = 150) -> None:
    """Top-down scatter colored by height (`:628-674`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = points
    if height_threshold is not None:
        pts = pts[pts[:, 1] >= height_threshold]
    fig = plt.figure(figsize=(12, 12))
    try:
        if len(pts):
            plt.scatter(pts[:, 0], pts[:, 2], s=1, c=pts[:, 1], cmap="viridis")
            plt.colorbar(label="Height (m)")
        plt.axis("equal")
        plt.title("Point distribution (top-down)")
        plt.savefig(output_path, dpi=dpi, bbox_inches="tight")
    finally:
        plt.close(fig)


def _height_ramp_bgr(h_norm: float) -> tuple[int, int, int]:
    """The reference's blue->green->red height ramp (`:786-790`), BGR."""
    r = int(255 * h_norm)
    g = int(255 * (1 - abs(2 * h_norm - 1)))
    b = int(255 * (1 - h_norm))
    return (b, g, r)


def create_direct_floorplan(points: np.ndarray, output_path: str,
                            height_threshold: float | None = None,
                            grid_resolution: float = 0.05, simplified: bool = True,
                            fast_mode: bool = False, max_height: float = 2.5,
                            dpi: int = 150) -> np.ndarray:
    """Direct occupancy floorplan (`:676-886`): contours filled with the
    per-contour MEAN height on the reference's absolute blue-green-red
    ramp (max_height = 2.5 m — colors keep their meaning across frames),
    black simplified outlines, bottom-right 1 m scale bar, title text.
    The per-point projection/max-height pass is vectorized (the
    reference loops over every point)."""
    import cv2

    pts = points
    title = "Floor Plan - All Objects"
    if height_threshold is not None:
        pts = pts[pts[:, 1] >= height_threshold]
        title = f"Floor Plan - Objects Above {height_threshold:.2f}m"
    if fast_mode:
        grid_resolution *= 2
        if len(pts) > 200_000:
            pts = pts[np.random.default_rng(0).choice(len(pts), 200_000, replace=False)]
    if len(pts) == 0:
        img = np.full((64, 64, 3), 255, np.uint8)
        cv2.imwrite(output_path, img)
        return img

    pts2d = pts[:, [0, 2]]
    grid, origin, res = create_density_grid(pts2d, grid_resolution, padding=0.5)
    nz, nx = grid.shape
    # max height per cell (vectorized)
    xi = np.clip(((pts2d[:, 0] - origin[0]) / res).astype(int), 0, nx - 1)
    zi = np.clip(((pts2d[:, 1] - origin[1]) / res).astype(int), 0, nz - 1)
    hmax = np.zeros((nz, nx), np.float32)
    np.maximum.at(hmax, (zi, xi), pts[:, 1])

    occupied = (grid > 0).astype(np.uint8)
    img = np.full((nz, nx, 3), 255, np.uint8)
    if simplified:
        cleaned = cv2.morphologyEx(occupied, cv2.MORPH_CLOSE, np.ones((3, 3), np.uint8))
        if not fast_mode:
            cleaned = cv2.morphologyEx(cleaned, cv2.MORPH_OPEN, np.ones((3, 3), np.uint8))
        contours, _ = cv2.findContours(cleaned, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        for contour in contours:
            if cv2.contourArea(contour) <= 5:  # reference noise filter
                continue
            eps = 0.01 * cv2.arcLength(contour, True)
            approx = cv2.approxPolyDP(contour, eps, True)
            mask = np.zeros((nz, nx), np.uint8)
            cv2.drawContours(mask, [contour], 0, 1, -1)
            inside = hmax[mask == 1]
            if len(inside):
                fill = _height_ramp_bgr(min(1.0, float(np.mean(inside)) / max_height))
            else:
                fill = (180, 180, 180)
            cv2.drawContours(img, [approx], 0, fill, -1)
            cv2.drawContours(img, [approx], 0, (0, 0, 0), 1)
    else:
        # per-cell height coloring with a dilation outline (`:846-855`)
        h_norm = np.minimum(hmax / max_height, 1.0)
        bgr = np.stack([
            (255 * (1 - h_norm)), (255 * (1 - np.abs(2 * h_norm - 1))), (255 * h_norm)
        ], axis=-1).astype(np.uint8)
        img[occupied > 0] = bgr[occupied > 0]
        edges = cv2.dilate(occupied, np.ones((3, 3), np.uint8)) & ~occupied
        img[edges > 0] = 0

    # 1 m scale bar, bottom-right (`:856-875`)
    bar = int(1.0 / res)
    bar_h = 10 if fast_mode else 20
    margin = 30 if fast_mode else 50
    x0 = min(nx - margin - bar, nx - 10)
    y0 = min(nz - margin, nz - 10)
    if x0 > 0 and 0 < y0 < nz and x0 + bar < nx:
        img[y0:y0 + bar_h, x0:x0 + bar] = 0
        cv2.putText(img, "1m", (x0, y0 - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    cv2.putText(img, title, (10, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 0), 1)

    cv2.imwrite(output_path, img)  # BGR, z increasing downward like the reference
    return img


# ---------------------------------------------------------------------------
# orchestrator


def pointcloud_to_floorplan(pointcloud_path: str, output_dir: str | None = None,
                            height_threshold: float | None = None,
                            grid_resolution: float = 0.05, min_area: float = 0.1,
                            num_slices: int = 5,
                            detect_floor: bool = True, fast_mode: bool = False,
                            seed: int = 0) -> dict:
    """PLY -> 4 outputs: colored height plan, polygon data txt, simple
    scatter, direct floorplan (`:888-1053`)."""
    from .pointcloud import read_ply

    output_dir = output_dir or os.path.dirname(os.path.abspath(pointcloud_path))
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(pointcloud_path))[0]

    cloud = read_ply(pointcloud_path)
    points = cloud.points
    if detect_floor:
        floor, _ = detect_floor_plane(cloud, seed=seed)
        points = normalize_points_to_floor(points, floor)

    slices = create_height_slices(points, cloud.colors,
                                  height_threshold=height_threshold,
                                  num_slices=num_slices)
    polygons = create_colored_height_map(slices, grid_resolution, min_area,
                                         height_threshold=height_threshold)

    outputs = {
        "floorplan": os.path.join(output_dir, f"{stem}_floorplan.png"),
        "data": os.path.join(output_dir, f"{stem}_floorplan.txt"),
        "simple": os.path.join(output_dir, f"{stem}_simple_points.png"),
        "direct": os.path.join(output_dir, f"{stem}_direct_floorplan.png"),
    }
    plot_floorplan(polygons, outputs["floorplan"])
    save_floorplan_data(polygons, outputs["data"])
    create_simple_point_visualization(points, outputs["simple"], height_threshold)
    create_direct_floorplan(points, outputs["direct"], height_threshold,
                            grid_resolution, fast_mode=fast_mode)
    return outputs


def main(argv=None):  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser(description="Cleaned point cloud -> floor plans")
    ap.add_argument("pointcloud", help="input .ply")
    ap.add_argument("-o", "--output_dir", default=None)
    ap.add_argument("--height_threshold", type=float, default=None)
    ap.add_argument("--grid_resolution", type=float, default=0.05)
    ap.add_argument("--min_area", type=float, default=0.1)
    ap.add_argument("--num_slices", type=int, default=5)
    ap.add_argument("--no_floor_detect", dest="detect_floor", action="store_false")
    ap.add_argument("--fast", dest="fast_mode", action="store_true")
    args = ap.parse_args(argv)
    outs = pointcloud_to_floorplan(args.pointcloud, args.output_dir,
                                   height_threshold=args.height_threshold,
                                   grid_resolution=args.grid_resolution,
                                   min_area=args.min_area,
                                   num_slices=args.num_slices,
                                   detect_floor=args.detect_floor,
                                   fast_mode=args.fast_mode)
    for k, v in outs.items():
        print(f"{k}: {v}")


if __name__ == "__main__":  # pragma: no cover
    main()
