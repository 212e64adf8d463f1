"""Ground-plane estimation, normalization and grid adjustment.

Re-implements the reference's ground stack with the same behavioral
contract but vectorized and fully seeded (SURVEY §7 hard-part #6: the
reference's RANSAC/sampling is nondeterministic; ours takes an explicit
seed):

- ``fit_ground_plane``     — Z-binning lowest-5% ground trace + seeded
  RANSAC ``y = a*x + c*z + d`` with horizontal fallback and plane
  lowering so <=0.1% of points end up below
  (`img_to_normalized_pointcloud.py:601-816`).
- ``optimize_ground_plane`` — spherical-coordinate L-BFGS-B refinement
  with the reference's penalty structure, +-20 deg bounds and
  revert-if-worse (`:376-599`).
- ``normalize_to_ground``  — Rodrigues rotation of the normal to
  [0,1,0], translate ground to y=0, clamp ground points, floor others
  at -0.1 m (`:880-981`).
- ``grid_ground_adjustment`` — 20x20 XZ grid, per-cell lowering by the
  5th percentile of low points with height-graduated falloff
  (`:983-1118`).
- JSON persistence of {normal, d, origin} as ``ground.json`` (`:225-312`).

Copy of ``ml_depth_pro_video_tpu/geom/ground.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os

import numpy as np

HORIZONTAL = np.array([0.0, 1.0, 0.0])


def plane_distances(normal, d, points) -> np.ndarray:
    """Signed distances to plane n.p + d = 0 (positive above)."""
    normal = np.asarray(normal, dtype=np.float64)
    normal = normal / np.linalg.norm(normal)
    return points @ normal + d


def rotation_between(from_vec: np.ndarray, to_vec: np.ndarray) -> np.ndarray:
    """Rodrigues rotation matrix taking ``from_vec`` to ``to_vec``."""
    a = from_vec / np.linalg.norm(from_vec)
    b = to_vec / np.linalg.norm(to_vec)
    cos = float(np.clip(a @ b, -1.0, 1.0))
    axis = np.cross(a, b)
    norm = np.linalg.norm(axis)
    if norm < 1e-12:
        if cos > 0:
            return np.eye(3)
        # antiparallel: -I is a REFLECTION (det=-1, mirrors the cloud);
        # the proper map is a 180° rotation about any axis ⊥ a
        perp = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(perp) < 1e-6:
            perp = np.cross(a, [0.0, 1.0, 0.0])
        perp = perp / np.linalg.norm(perp)
        return 2.0 * np.outer(perp, perp) - np.eye(3)
    axis = axis / norm
    angle = np.arccos(cos)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def euler_rotation(deg_xyz) -> np.ndarray:
    """Rz @ Ry @ Rx from per-axis angles in degrees."""
    rx, ry, rz = np.radians(np.asarray(deg_xyz, dtype=np.float64))
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def apply_rotation_to_plane(model: dict, rotation_offset_deg) -> dict:
    """Rotate the plane normal by manual per-axis offsets (degrees)."""
    if model is None:
        return None
    R = euler_rotation(rotation_offset_deg)
    normal = R @ np.asarray(model["normal"], dtype=np.float64)
    normal /= np.linalg.norm(normal)
    out = dict(model)
    out["normal"] = normal
    out["d"] = -float(normal @ np.asarray(model["origin"], dtype=np.float64))
    return out


# ---------------------------------------------------------------------------
# persistence (ground.json schema-compatible with the reference)


def save_ground_plane(model: dict, directory: str, filename: str = "ground.json") -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    with open(path, "w") as f:
        json.dump(
            {
                "normal": np.asarray(model["normal"], dtype=float).tolist(),
                "d": float(model["d"]),
                "origin": np.asarray(model["origin"], dtype=float).tolist(),
            },
            f,
            indent=4,
        )
    return path


def load_ground_plane(directory: str, filename: str = "ground.json",
                      image_path: str | None = None) -> dict | None:
    path = os.path.join(directory, filename)
    if not os.path.exists(path) and image_path is not None:
        # legacy per-image filename fallback
        # (`img_to_normalized_pointcloud.py:283-288`)
        stem = os.path.splitext(os.path.basename(image_path))[0]
        legacy = os.path.join(directory, f"{stem}_ground_plane.json")
        if os.path.exists(legacy):
            path = legacy
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    return {
        "normal": np.asarray(data["normal"], dtype=np.float64),
        "d": float(data["d"]),
        "origin": np.asarray(data["origin"], dtype=np.float64),
    }


# ---------------------------------------------------------------------------
# fitting


def _ransac_plane_xz(points: np.ndarray, rng: np.random.Generator,
                     n_iters: int = 1000, sample: int = 10,
                     residual: float = 0.1):
    """Seeded RANSAC of y = a*x + c*z + d over (N,3) trace points.
    Vectorized over all iterations at once: sample all candidate index
    sets, solve the least-squares fits in a batch, score inliers."""
    n = len(points)
    sample = min(sample, n)
    idx = rng.integers(0, n, size=(n_iters, sample))
    xz = np.concatenate([points[:, [0, 2]], np.ones((n, 1))], axis=1)  # (N,3)
    y = points[:, 1]
    A = xz[idx]  # (I, S, 3)
    B = y[idx]  # (I, S)
    # batched least squares via normal equations (3x3 solves)
    AtA = np.einsum("isk,isl->ikl", A, A)
    Atb = np.einsum("isk,is->ik", A, B)
    ok = np.linalg.det(AtA) > 1e-12
    coef = np.zeros((n_iters, 3))
    coef[ok] = np.linalg.solve(AtA[ok], Atb[ok][..., None])[..., 0]
    # score in chunks of iterations: the full (N, I) residual matrix is
    # ~1 GB when the trace fallback feeds 100k+ points
    inliers = np.empty(n_iters, np.int64)
    chunk = max(1, int(5e7 // max(n, 1)))
    for i in range(0, n_iters, chunk):
        resid = np.abs(xz @ coef[i:i + chunk].T - y[:, None])
        inliers[i:i + chunk] = (resid < residual).sum(axis=0)
    inliers[~ok] = -1
    best = int(np.argmax(inliers))
    # refit on the best consensus set
    mask = np.abs(xz @ coef[best] - y) < residual
    if mask.sum() >= 3:
        coef_best, *_ = np.linalg.lstsq(xz[mask], y[mask], rcond=None)
    else:
        coef_best = coef[best]
    return coef_best  # (a, c, d) with y = a*x + c*z + d


def fit_ground_plane(points_3d: np.ndarray, initial_model: dict | None = None,
                     n_bins: int = 20, seed: int = 0) -> dict:
    """Z-binning ground-trace fit (see module docstring)."""
    points = np.asarray(points_3d, dtype=np.float64)
    points = points[~np.isnan(points).any(axis=1)]
    rng = np.random.default_rng(seed)

    z = points[:, 2]
    scene_scale = float(np.median(z))
    # bin edges come from the FULL cloud even when the near-ground
    # filter narrows the points below (reference ordering,
    # `img_to_normalized_pointcloud.py:630` before `:639-667`)
    z_min, z_max = z.min(), z.max()

    if initial_model is not None:
        dist = plane_distances(initial_model["normal"], initial_model["d"], points)
        near = (dist > -0.10 * scene_scale) & (dist < 0.05 * scene_scale)
        if near.sum() > 100:
            points = points[near]
            z = points[:, 2]
    edges = np.linspace(z_min, z_max, n_bins + 1)
    bin_idx = np.clip(np.digitize(z, edges) - 1, 0, n_bins - 1)
    trace = []
    for b in range(n_bins):
        m = bin_idx == b
        cnt = int(m.sum())
        if cnt > 10:
            ys = points[m, 1]
            k = max(1, int(0.05 * cnt))
            low = np.argpartition(ys, k - 1)[:k]
            trace.append(points[m][low].mean(axis=0))
    trace = np.asarray(trace)
    if len(trace) < 10:
        order = np.argsort(points[:, 1])
        k = max(10, int(0.05 * len(points)))
        trace = points[order[:k]]

    # RANSAC fit y = a*x + c*z + d -> plane normal [-a, 1, -c].
    # Deliberate deviation from `img_to_normalized_pointcloud.py:729-733`:
    # the reference normalizes the normal but leaves d unscaled, which
    # shifts the working plane by (1 - 1/||n||)·d for tilted fits; we
    # scale d consistently so (normal, d) is the actual fitted plane.
    a, c, d0 = _ransac_plane_xz(trace, rng)
    normal = np.array([-a, 1.0, -c])
    d_plane = -d0
    normal_norm = np.linalg.norm(normal)
    d_plane /= normal_norm
    normal = normal / normal_norm

    # the steepness check below uses the RANSAC fit's angle even when
    # the initial model is restored — reference ordering
    # (`img_to_normalized_pointcloud.py:738-759`): a steep fresh fit
    # signals an unreliable trace and forces the horizontal fallback
    angle_deg = np.degrees(np.arccos(np.clip(abs(normal @ HORIZONTAL), -1, 1)))

    if initial_model is not None:
        init_n = np.asarray(initial_model["normal"], dtype=np.float64)
        dev = np.degrees(np.arccos(np.clip(normal @ init_n, -1, 1)))
        if dev > 20:
            normal, d_plane = init_n, float(initial_model["d"])

    if angle_deg > 20:
        # too steep: horizontal fallback at the median trace height
        normal = HORIZONTAL.copy()
        d_plane = -float(np.median(trace[:, 1]))

    if normal[1] < 0:
        normal, d_plane = -normal, -d_plane

    # lower the plane so at most 0.1% of points are below
    dist = points @ normal + d_plane
    below = int((dist < 0).sum())
    if below > 0.001 * len(points):
        d_plane -= float(np.percentile(dist, 0.1)) + 0.05

    return {
        "normal": normal,
        "d": float(d_plane),
        "origin": np.array([0.0, -d_plane / normal[1] if normal[1] != 0 else 0.0, 0.0]),
    }


def optimize_ground_plane(points_3d: np.ndarray, model: dict,
                          min_points_above: float = 0.95) -> dict:
    """L-BFGS-B refinement of (theta, phi, d) with the reference's
    penalty structure; reverts when the result is worse."""
    from scipy.optimize import minimize

    if model is None or len(points_3d) == 0:
        return model
    points = np.asarray(points_3d, dtype=np.float64)

    normal0 = np.asarray(model["normal"], dtype=np.float64)
    normal0 = normal0 / np.linalg.norm(normal0)
    d0 = float(model["d"])
    if normal0 @ HORIZONTAL < 0:
        normal0, d0 = -normal0, -d0

    median_depth = float(np.median(points[:, 2]))
    ground_thresh = 0.05 * median_depth
    near = np.abs(points @ normal0 + d0) < ground_thresh
    order = np.argsort(points[:, 1])
    lowest = order[: max(int(0.2 * len(points)), 100)]
    cand_idx = np.union1d(np.nonzero(near)[0], lowest)
    candidates = points[cand_idx]

    theta0 = float(np.arccos(np.clip(normal0[1], -1, 1)))
    phi0 = float(np.arctan2(normal0[2], normal0[0]))
    above_thresh = 0.1 * median_depth

    def to_plane(params):
        theta, phi, d_off = params
        n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)])
        if n @ normal0 < 0:
            n = -n
        return n, d0 + d_off

    def objective(params):
        n, d = to_plane(params)
        dist = points @ n + d
        frac_below = float((dist < 0).mean())
        pen = 1000 * frac_below if frac_below > (1 - min_points_above) else 0.0

        gdist = candidates @ n + d
        below = gdist < 0
        if below.any():
            pen += 10 * float(np.abs(gdist[below]).sum())
        high = gdist > above_thresh
        if high.any():
            pen += 5 * float((gdist[high] - above_thresh).sum())
        close = np.abs(gdist) < above_thresh
        if close.sum() > 1:
            pen += 10 * float(np.var(gdist[close]))
        pen += 2 * (1 - abs(float(n @ HORIZONTAL)))
        pen += 50 * (1 - abs(float(n @ normal0)))
        return pen

    max_change = np.radians(20)
    bounds = [
        (max(0.0, theta0 - max_change), min(np.pi, theta0 + max_change)),
        (phi0 - max_change, phi0 + max_change),
        (-0.3, 0.3),
    ]
    res = minimize(objective, [theta0, phi0, 0.0], method="L-BFGS-B",
                   bounds=bounds, options={"maxiter": 100})
    normal1, d1 = to_plane(res.x)

    below1 = float(((points @ normal1 + d1) < 0).mean())
    angle = np.degrees(np.arccos(np.clip(normal0 @ normal1, -1, 1)))
    if below1 > 0.3 or angle > 30:
        return model
    out = dict(model)
    out["normal"], out["d"] = normal1, float(d1)
    return out


# ---------------------------------------------------------------------------
# normalization / adjustment


def normalize_to_ground(points_3d: np.ndarray, model: dict) -> np.ndarray:
    """Rotate/translate so the ground plane becomes y = 0 (see module
    docstring for the clamping rules)."""
    points = np.asarray(points_3d, dtype=np.float64)
    if len(points) == 0:
        return points.copy()
    normal = np.asarray(model["normal"], dtype=np.float64)
    d = float(model["d"])

    dist = plane_distances(normal, d, points)

    if abs(normal @ HORIZONTAL) > 0.99:
        out = points.copy()
    else:
        R = rotation_between(normal, HORIZONTAL)
        out = points @ R.T
        rotated_normal = R @ normal
        out[:, 1] -= -d / rotated_normal[1]

    ground_y = out[np.abs(dist) < 0.1, 1]
    if len(ground_y) > 10:
        out[:, 1] -= np.percentile(ground_y, 2)

    ground_mask = np.abs(dist) < 0.05
    below_ground = (out[:, 1] < 0) & ground_mask
    out[below_ground, 1] = 0.0
    non_ground_below = (out[:, 1] < -0.1) & ~ground_mask
    out[non_ground_below, 1] = -0.1
    return out


def grid_ground_adjustment(points_3d: np.ndarray, grid_size: int = 20,
                           percentile: float = 5.0) -> np.ndarray:
    """Per-XZ-cell lowering with height-graduated falloff (full below
    0.1 m, linear to zero at 1.5 m)."""
    points = np.asarray(points_3d, dtype=np.float64)
    out = points.copy()
    if len(points) == 0:
        return out
    x, y, z = points[:, 0], points[:, 1], points[:, 2]

    x_edges = np.linspace(x.min(), x.max(), grid_size + 1)
    z_edges = np.linspace(z.min(), z.max(), grid_size + 1)
    xi = np.clip(np.digitize(x, x_edges) - 1, 0, grid_size - 1)
    zi = np.clip(np.digitize(z, z_edges) - 1, 0, grid_size - 1)
    cell = xi * grid_size + zi

    # group points per cell with one sort (O(N log N), not O(N * cells))
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    starts = np.nonzero(np.r_[True, cell_sorted[1:] != cell_sorted[:-1]])[0]
    ends = np.r_[starts[1:], len(order)]

    # per-cell lowering = percentile of the <0.2m points in that cell
    y_pct_per_point = np.zeros(len(points))
    for s, e in zip(starts, ends):
        sel = order[s:e]
        if len(sel) < 10:
            continue
        cy = y[sel]
        low = cy[cy < 0.2]
        if len(low) < 5:
            continue
        y_pct = np.percentile(low, percentile)
        if y_pct > 0.01:
            y_pct_per_point[sel] = y_pct

    # height-graduated adjustment, fully vectorized
    active = y_pct_per_point > 0
    adj = np.zeros(len(points))
    near = active & (y < 0.1)
    adj[near] = y_pct_per_point[near]
    mid = active & (y >= 0.1) & (y < 1.5)
    adj[mid] = y_pct_per_point[mid] * (1.0 - (y[mid] - 0.1) / 1.4)
    out[:, 1] -= adj
    clipped = active & (out[:, 1] < 0)
    out[clipped, 1] = 0.0
    return out
