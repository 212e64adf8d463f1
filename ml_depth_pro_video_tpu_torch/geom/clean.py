"""Point-cloud cleaning: stray-point removal and shadow-column cleanup.

Behavioral parity with the reference's `pointcloud_cleaner.py:142-309`
but vectorized: the reference loops a KD-tree query per point in Python
batches; here neighbor counting is one batched cKDTree query (and the
optional C++ grid-hash counter in ``native/`` when built), and shadow
detection pre-selects tall cells with grouped reductions before the
per-cell angle analysis.

Copy of ``ml_depth_pro_video_tpu/geom/clean.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from .pointcloud import PointCloud

try:
    from ..native import neighbors as _native
except Exception:  # pragma: no cover
    _native = None


def radius_neighbor_counts(points: np.ndarray, radius: float) -> np.ndarray:
    """Number of neighbors (excluding self) within ``radius`` per point."""
    if _native is not None and _native.available():
        return _native.radius_counts(points, radius)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    counts = tree.query_ball_point(points, r=radius, return_length=True, workers=-1)
    return np.asarray(counts) - 1  # query includes the point itself


def remove_stray_points(cloud: PointCloud, nb_points: int = 20, radius: float = 0.1) -> PointCloud:
    """Keep points with >= nb_points neighbors within radius.

    The reference counts the point itself via Open3D's radius search
    (`pointcloud_cleaner.py:184-187`), so the threshold here is
    ``counts + 1 >= nb_points``.
    """
    if len(cloud) == 0:
        return cloud.copy()
    if _native is not None and _native.available():
        # early-exit mask: point kept once nb_points-1 neighbors are seen
        mask = _native.radius_mask(cloud.points, radius, nb_points - 1)
        return cloud.select(mask)
    counts = radius_neighbor_counts(cloud.points, radius)
    return cloud.select(counts + 1 >= nb_points)


def clean_shadows(
    cloud: PointCloud,
    shadow_height_threshold: float = 0.1,
    max_shadow_angle: float = 75.0,
    min_points_per_column: int = 3,
) -> PointCloud:
    """Drop XZ-grid cells whose points form tall near-vertical columns
    (monocular depth 'shadow' streaks)."""
    points = cloud.points
    n = len(points)
    if n == 0:
        return cloud.copy()

    if _native is not None and _native.available():
        # threaded C++ twin (native/shadows.cpp): identical verdicts,
        # one stable (cell, y) sort instead of the lexsort + ~15
        # full-array passes below — this was the pipeline's dominant
        # host stage (scripts/pipeline_stage_budget.out)
        mask = _native.clean_shadows_mask(
            points, shadow_height_threshold, max_shadow_angle,
            min_points_per_column)
        if mask is not None:  # None = stale prebuilt .so without the symbol
            return cloud.select(mask)
    return clean_shadows_numpy(cloud, shadow_height_threshold,
                               max_shadow_angle, min_points_per_column)


def clean_shadows_numpy(
    cloud: PointCloud,
    shadow_height_threshold: float = 0.1,
    max_shadow_angle: float = 75.0,
    min_points_per_column: int = 3,
) -> PointCloud:
    """Vectorized numpy fallback (and the native twin's parity oracle)."""
    points = cloud.points
    n = len(points)
    if n == 0:
        return cloud.copy()

    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    x_min, x_max = x.min(), x.max()
    z_min, z_max = z.min(), z.max()
    area = max((x_max - x_min) * (z_max - z_min), 1e-9)
    density = n / area
    cell_size = max(0.05, 1.0 / np.sqrt(max(density / 10.0, 1e-12)))

    nx = max(int(np.ceil((x_max - x_min) / cell_size)), 1)
    nz = max(int(np.ceil((z_max - z_min) / cell_size)), 1)
    xi = np.minimum(((x - x_min) / cell_size).astype(np.int64), nx - 1)
    zi = np.minimum(((z - z_min) / cell_size).astype(np.int64), nz - 1)
    cell = xi * nz + zi

    # group points by cell (height-sorted within cells), then do the
    # whole tall-column analysis with segment reductions — no per-cell
    # Python loop (that loop cost ~8 s on a 2.4M-point frame)
    order = np.lexsort((y, cell))
    cell_sorted = cell[order]
    new_seg = np.r_[True, cell_sorted[1:] != cell_sorted[:-1]]
    starts = np.nonzero(new_seg)[0]
    ends = np.r_[starts[1:], n]
    counts = ends - starts
    ys = y[order]

    # qualifying cells: enough points AND tall (ys ascending per cell)
    qual_seg = (counts >= max(min_points_per_column, 3)) & (
        ys[ends - 1] - ys[starts] > shadow_height_threshold
    )
    if not qual_seg.any():
        return cloud.select(np.ones(n, dtype=bool))

    seg_id = np.cumsum(new_seg) - 1  # per sorted point -> segment index
    # consecutive height-sorted pairs within one cell, in qualifying
    # cells — componentwise 1-D diffs, no (N,3) gather/compress
    pair_same = cell_sorted[1:] == cell_sorted[:-1]
    pair_seg = seg_id[:-1]
    pmask = pair_same & qual_seg[pair_seg]
    xs, zs = x[order], z[order]
    dvy = np.diff(ys)
    dn2 = dvy * dvy + np.diff(xs) ** 2 + np.diff(zs) ** 2
    vy = dvy[pmask]
    n2 = dn2[pmask]
    pseg = pair_seg[pmask]

    # median(angle) < t reduces to COUNTING pairs with angle < t:
    # angle < t  <=>  vy > cos(t)*|vec|, evaluated sqrt/arccos-free by
    # sign-aware squaring — for t <= 90 (cos t >= 0) that is
    # vy > 0 and vy^2 > cos^2(t)*|vec|^2; for t > 90 (cos t < 0) it is
    # NOT(vy < 0 and vy^2 >= cos^2(t)*|vec|^2) (the naive squared test
    # silently kept every >90-degree cell). For odd pair-count m the
    # median is < t iff count >= (m+1)/2; for even m only the boundary
    # case count == m/2 needs the two middle values, computed exactly
    # for just those (few) cells. Zero-length pairs (duplicate points)
    # make the reference's angle median NaN (0/0,
    # `pointcloud_cleaner.py:290-293`) and NaN < t is False — such
    # cells are ALWAYS kept; replicated below.
    cos_t = np.cos(np.radians(max_shadow_angle))
    if cos_t >= 0:
        below = (vy > 0) & (vy * vy > cos_t * cos_t * n2)
    else:
        below = ~((vy < 0) & (vy * vy >= cos_t * cos_t * n2))

    n_seg = len(starts)
    m = np.bincount(pseg, minlength=n_seg)
    cnt_below = np.bincount(pseg[below], minlength=n_seg)
    drop_seg = np.zeros(n_seg, dtype=bool)
    has_pairs = m > 0
    odd = has_pairs & (m % 2 == 1)
    even = has_pairs & ~odd
    drop_seg[odd] = cnt_below[odd] >= (m[odd] + 1) // 2
    drop_seg[even] = cnt_below[even] >= m[even] // 2 + 1
    boundary = even & (cnt_below == m // 2)
    if boundary.any():
        # exact medians for just the boundary cells: compress their
        # pairs, one sort by (cell, angle), average the two middles
        bmask = boundary[pseg]
        bvy, bn2, bseg = vy[bmask], n2[bmask], pseg[bmask]
        norms = np.sqrt(bn2)
        norms[norms == 0] = 1e-12
        bang = np.degrees(np.arccos(np.clip(bvy / norms, -1.0, 1.0)))
        border = np.lexsort((bang, bseg))
        a_sorted, s_sorted = bang[border], bseg[border]
        b_new = np.r_[True, s_sorted[1:] != s_sorted[:-1]]
        b_starts = np.nonzero(b_new)[0]
        b_counts = np.r_[b_starts[1:], len(s_sorted)] - b_starts
        med = 0.5 * (a_sorted[b_starts + b_counts // 2 - 1]
                     + a_sorted[b_starts + b_counts // 2])
        drop_seg[s_sorted[b_starts]] = med < max_shadow_angle

    # duplicate-point pairs poison the reference's median with NaN ->
    # cell kept; match that verdict exactly
    if (n2 == 0).any():
        drop_seg[np.bincount(pseg[n2 == 0], minlength=n_seg) > 0] = False

    keep = np.ones(n, dtype=bool)
    keep[order] = ~drop_seg[seg_id]
    return cloud.select(keep)
