"""Surface reconstruction: point cloud -> triangle mesh.

Capability parity with the reference's `pointcloud_to_mesh.py:313-465`
(normal estimation + camera orientation, voxel downsampling, Poisson /
ball-pivoting / simple triangulation, low-density vertex filtering,
mesh cleanup) without Open3D:

- **poisson** — our own grid SCREENED Poisson reconstruction: normals
  are trilinearly splatted into a vector field V on a regular grid, the
  indicator chi solves (lap - alpha·D) chi = div V — the screened
  Poisson equation of Kazhdan-Hoppe 2013 with lumped-diagonal sample
  weights D, matching the reference's Open3D call, which is screened
  (`pointcloud_to_mesh.py:356`; alpha=0 recovers the plain equation) —
  via matrix-free conjugate gradients (7-point Laplacian as array
  shifts), and the iso-surface is extracted with marching tetrahedra
  (6-tet Kuhn cube decomposition — no big marching-cubes tables).
  Low-density vertices (bottom 10% of the splat-density quantile, like
  the reference's Open3D density filter) are removed. Depth <= 8
  (the reference's octree default) solves the dense grid with the CG
  in PyTorch ops on the caller's device; depth >= 9 switches to a sparse
  narrow-band solve (`poisson_reconstruct_sparse`): a coarse dense
  solve supplies global topology / Dirichlet data and the indicator is
  refined at full resolution only on a thin band of nodes around the
  samples — 512^3+ effective resolution without 512^3 memory.
- **ball_pivoting** — approximated by tangent-plane fan triangulation
  over k-NN neighborhoods with radius-limited edges (same role: direct
  surface over a dense cloud).
- **simple** — the reference's 6-NN fan triangulation.

Port of ``ml_depth_pro_video_tpu/geom/mesh.py``: the host part is a copy
(the port imports nothing of the JAX package); the dense CG
(``_poisson_cg_device``), a ``jax.jit`` loop there, is plain PyTorch ops on
the ``device`` that ``create_mesh_from_pointcloud`` threads down (default
``cuda``). One difference on purpose: a failing device solve raises, where
the JAX package logs a warning and solves again with a host numpy CG.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..core.precision import resolve_device
from .pointcloud import PointCloud, write_obj

logger = logging.getLogger(__name__)

try:
    from ..native import neighbors as _native
except Exception:  # pragma: no cover
    _native = None


@dataclasses.dataclass
class TriangleMesh:
    vertices: np.ndarray  # (V, 3)
    faces: np.ndarray  # (F, 3) int
    vertex_colors: np.ndarray | None = None

    def cleanup(self) -> "TriangleMesh":
        """Remove degenerate and duplicated triangles/vertices."""
        faces = np.asarray(self.faces, dtype=np.int64)
        # drop degenerate (repeated vertex index)
        ok = (
            (faces[:, 0] != faces[:, 1])
            & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2])
        )
        faces = faces[ok]
        # dedupe triangles irrespective of winding
        key = np.sort(faces, axis=1)
        _, uniq = np.unique(key, axis=0, return_index=True)
        faces = faces[np.sort(uniq)]
        # drop unreferenced vertices
        used = np.unique(faces)
        remap = -np.ones(len(self.vertices), dtype=np.int64)
        remap[used] = np.arange(len(used))
        return TriangleMesh(
            self.vertices[used],
            remap[faces],
            self.vertex_colors[used] if self.vertex_colors is not None else None,
        )

    def save_obj(self, path: str) -> None:
        write_obj(path, self.vertices, self.faces, self.vertex_colors)


# ---------------------------------------------------------------------------
# normals / downsampling


def estimate_normals(points: np.ndarray, radius: float, camera=(0.0, 0.0, 0.0),
                     max_nn: int = 30) -> np.ndarray:
    """PCA normals from neighbors within ``radius``, oriented towards the
    camera (reference: KDTreeSearchParamHybrid + orient_towards_camera)."""
    if _native is not None and _native.available():
        return _native.estimate_normals(points, radius, camera)
    from scipy.spatial import cKDTree

    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 0:
        return np.zeros((0, 3))
    k = min(max_nn, len(pts))
    tree = cKDTree(pts)
    normals = np.zeros_like(pts)
    # batched masked-PCA: per chunk, gather the (n, k, 3) neighbor block,
    # zero-weight neighbors outside the radius, and eigensolve all the
    # 3x3 covariances at once (same math as the per-point loop, ~100x
    # faster on large clouds without the native lib)
    chunk = 65536
    for s in range(0, len(pts), chunk):
        p = pts[s:s + chunk]
        dist, idx = tree.query(p, k=k, workers=-1)
        if k == 1:
            dist = dist[:, None]
            idx = idx[:, None]
        w = (dist <= radius).astype(np.float64)
        counts = w.sum(axis=1)
        nbr = pts[idx]
        mean = (nbr * w[..., None]).sum(axis=1) / np.maximum(counts, 1)[:, None]
        q = (nbr - mean[:, None, :]) * w[..., None]
        cov = np.einsum("nki,nkj->nij", q, q)
        _, vecs = np.linalg.eigh(cov)
        n = vecs[..., 0]
        n[counts < 3] = [0.0, 1.0, 0.0]
        normals[s:s + chunk] = n
    to_cam = np.asarray(camera) - pts
    flip = np.einsum("ij,ij->i", normals, to_cam) < 0
    normals[flip] *= -1
    return normals


def voxel_downsample(cloud: PointCloud, voxel: float) -> PointCloud:
    """Average points (and colors) per voxel."""
    if len(cloud) == 0:
        return cloud.copy()
    if _native is not None and _native.available():
        fused = _native.voxel_downsample(cloud.points, cloud.colors, voxel)
        if fused is not None:  # None: grid keys would wrap (tiny voxel)
            pts, cols = fused
            return PointCloud(pts, cols)
    keys = np.floor(cloud.points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    pts = np.zeros((len(counts), 3))
    np.add.at(pts, inv, cloud.points)
    pts /= counts[:, None]
    cols = None
    if cloud.colors is not None:
        cols = np.zeros((len(counts), 3))
        np.add.at(cols, inv, cloud.colors)
        cols /= counts[:, None]
    return PointCloud(pts, cols)


def average_point_distance(points: np.ndarray, k: int = 20, sample: int = 1000,
                           seed: int = 0) -> float:
    from scipy.spatial import cKDTree

    pts = np.asarray(points)
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(pts), min(sample, len(pts)), replace=False)
    tree = cKDTree(pts)
    dist, _ = tree.query(pts[sel], k=min(k + 1, len(pts)), workers=-1)
    return float(dist[:, 1:].mean())


# ---------------------------------------------------------------------------
# marching tetrahedra

# cube corners numbered by offset bits (x, y, z); Kuhn 6-tet decomposition
# along the 0-7 diagonal
_CUBE_OFFSETS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)])
_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
    [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7],
])
_TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])
# triangles (as edge-index triples) per inside-mask
_TET_CASES = {
    1: [(0, 1, 2)], 14: [(0, 2, 1)],
    2: [(0, 3, 4)], 13: [(0, 4, 3)],
    4: [(1, 3, 5)], 11: [(1, 5, 3)],
    8: [(2, 4, 5)], 7: [(2, 5, 4)],
    3: [(1, 3, 4), (1, 4, 2)], 12: [(1, 4, 3), (1, 2, 4)],
    5: [(0, 3, 5), (0, 5, 2)], 10: [(0, 5, 3), (0, 2, 5)],
    9: [(0, 4, 5), (0, 5, 1)], 6: [(0, 5, 4), (0, 1, 5)],
}


def marching_tetrahedra(values: np.ndarray, iso: float, origin: np.ndarray,
                        spacing: float) -> tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a (nx, ny, nz) scalar grid.

    Returns (vertices (V,3), faces (F,3)); vertices deduplicated.
    """
    nx, ny, nz = values.shape
    # Active-cell pre-filter: only cells whose 8 corners straddle the
    # iso level can emit triangles (typically a few % of the grid) —
    # avoids materializing corner tensors for the whole volume.
    inside_grid = values > iso
    all_in = np.ones((nx - 1, ny - 1, nz - 1), dtype=bool)
    any_in = np.zeros((nx - 1, ny - 1, nz - 1), dtype=bool)
    for dx, dy, dz in _CUBE_OFFSETS:
        corner = inside_grid[dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz]
        all_in &= corner
        any_in |= corner
    active = np.nonzero((any_in & ~all_in).ravel())[0]
    if len(active) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    cx, cy, cz = np.unravel_index(active, (nx - 1, ny - 1, nz - 1))
    base = np.stack([cx, cy, cz], axis=1)  # (C_active, 3)
    corner_idx = base[:, None, :] + _CUBE_OFFSETS[None, :, :]  # (C, 8, 3)
    corner_vals = values[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    corner_pos = origin + corner_idx * spacing
    return _march_cells(corner_vals, corner_pos, iso, spacing)


def _march_cells(corner_vals: np.ndarray, corner_pos: np.ndarray, iso: float,
                 spacing: float) -> tuple[np.ndarray, np.ndarray]:
    """Triangulate a batch of grid cells given their 8 corner values
    (C, 8) and positions (C, 8, 3) — shared by the dense grid and the
    sparse narrow-band Poisson paths."""
    tris = []
    inside = corner_vals > iso  # (C, 8)
    for tet in _TETS:
        tv = corner_vals[:, tet]  # (C, 4)
        tp = corner_pos[:, tet]  # (C, 4, 3)
        ti = inside[:, tet]  # (C, 4)
        mask = (ti * np.array([1, 2, 4, 8])).sum(axis=1)
        for case, tri_list in _TET_CASES.items():
            sel = np.nonzero(mask == case)[0]
            if len(sel) == 0:
                continue
            v = tv[sel]
            p = tp[sel]
            # interpolated point on each of the 6 tet edges
            a, b = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
            va, vb = v[:, a], v[:, b]  # (S, 6)
            denom = vb - va
            denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            t = np.clip((iso - va) / denom, 0.0, 1.0)[..., None]
            pe = p[:, a] + t * (p[:, b] - p[:, a])  # (S, 6, 3)
            for e0, e1, e2 in tri_list:
                tris.append(np.stack([pe[:, e0], pe[:, e1], pe[:, e2]], axis=1))
    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri_pts = np.concatenate(tris, axis=0).reshape(-1, 3)  # (3F, 3)
    # dedupe vertices on a fine lattice
    key = np.round(tri_pts / (spacing * 1e-4)).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    np.add.at(verts, inv, tri_pts)
    counts = np.bincount(inv)
    verts /= counts[:, None]
    faces = inv.reshape(-1, 3)
    return verts, faces


# ---------------------------------------------------------------------------
# Poisson reconstruction


# rechecking the exit test costs a host sync; between checks, iterations
# past it leave x as it was (see ``_poisson_cg``)
CG_CHECK_EVERY = 8


def _neg_lap(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Negated 7-point Laplacian with a zero-padding boundary, as array
    shifts, in the JAX package's order: ``6·x``, then the six shifted
    subtractions. Writes ``out``."""
    torch.mul(x, 6.0, out=out)
    out[1:, :, :] -= x[:-1, :, :]
    out[:-1, :, :] -= x[1:, :, :]
    out[:, 1:, :] -= x[:, :-1, :]
    out[:, :-1, :] -= x[:, 1:, :]
    out[:, :, 1:] -= x[:, :, :-1]
    out[:, :, :-1] -= x[:, :, 1:]
    return out


def _dot(a: torch.Tensor, b: torch.Tensor, prod: torch.Tensor,
         wide: torch.Tensor) -> torch.Tensor:
    """sum(a * b) for fp32 grids: the products in fp32 (into ``prod``), their
    sum in float64 (a copy in ``wide``), rounded to fp32. The JAX package
    sums in fp32, but in fp32 the card and the CPU sum in different orders,
    and at 256^3 the 300 iterations grow that into 7.4e-3 of max |chi|
    between them, while either lies 1.0e-2 to 1.5e-2 from a float64 solve
    (``scripts/torch_poisson_precision.py`` on an NVIDIA H100 80GB HBM3,
    700.00 W); summed in float64 both round to the same scalars. (Cast, then
    sum: on the CPU a sum with ``dtype=`` is many times slower.)"""
    torch.mul(a, b, out=prod)
    return wide.copy_(prod).sum().to(a.dtype)


def _poisson_cg(b: torch.Tensor, d: torch.Tensor | None, iters: int,
                tol: float) -> tuple[torch.Tensor, int]:
    """CG on (-lap + d)(x) = b for fp32 ``b`` (and ``d``) on their device.
    Returns (x, the iterations run).

    The JAX loop tests ``(i < iters) & (rs / |b|^2 > tol^2)`` on the device
    before every iteration. Here the test is a device flag that, once
    false, stays false, and x takes each update only while it is true; the
    host reads the flag every ``CG_CHECK_EVERY`` iterations and stops. So x
    is the JAX loop's iterate, with at most ``CG_CHECK_EVERY - 1`` idle
    iterations run past the exit (r and p are left to run on, unread).

    Every update runs in place on grids allocated once (a fresh 67 MB grid
    per operation costs the CPU its page faults), each rounding as the JAX
    expression it stands for: ``x + alpha·p``, ``r - alpha·Ap``,
    ``r + (rs_new / rs)·p``."""
    tmp, Ap = torch.empty_like(b), torch.empty_like(b)
    wide = torch.empty_like(b, dtype=torch.float64)
    rs = _dot(b, b, tmp, wide)
    b_norm2 = rs + 1e-30
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    active = rs / b_norm2 > tol * tol
    ran = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(iters):
        if i % CG_CHECK_EVERY == 0 and not bool(active):
            break
        ran += active
        _neg_lap(p, out=Ap)
        if d is not None:
            Ap += torch.mul(d, p, out=tmp)
        alpha = rs / (_dot(p, Ap, tmp, wide) + 1e-30)
        torch.where(active, torch.mul(p, alpha, out=tmp).add_(x), x, out=x)
        r -= torch.mul(Ap, alpha, out=tmp)
        rs_new = _dot(r, r, tmp, wide)
        p.mul_(rs_new / rs).add_(r)
        rs = rs_new
        active &= rs / b_norm2 > tol * tol
    return x, int(ran)


def _poisson_cg_device(b: np.ndarray, iters: int = 300, tol: float = 1e-6,
                       diag: np.ndarray | None = None, device="cuda") -> np.ndarray:
    """CG on (-lap + diag)(x) = b in fp32 on ``device`` (the Poisson solve
    is a pure stencil loop: one grid per vector, so 256^3 holds about 0.4 GB
    on the card). ``diag`` is the optional SCREENING term (Kazhdan-Hoppe): a
    pointwise sample-density penalty that anchors the indicator at the
    samples. Returns x as float64, as the JAX package does."""
    dev = resolve_device(device)
    bt = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    d = None if diag is None else torch.as_tensor(np.asarray(diag, np.float32), device=dev)
    x, _ = _poisson_cg(bt, d, iters, tol)
    return x.cpu().numpy().astype(np.float64)


def _corner_weights(frac: np.ndarray):
    """Yield (dx, dy, dz, w) trilinear weights for the 8 cell corners —
    the single home of the weight convention (splat dense/sparse and
    sampling all share it)."""
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (frac[:, 0] if dx else 1 - frac[:, 0])
                    * (frac[:, 1] if dy else 1 - frac[:, 1])
                    * (frac[:, 2] if dz else 1 - frac[:, 2])
                )
                yield dx, dy, dz, w


def _splat_trilinear(grid: np.ndarray, coords: np.ndarray, values: np.ndarray) -> None:
    """Accumulate per-point vector/scalar values into grid (in place)."""
    lo = np.floor(coords).astype(np.int64)
    shape = grid.shape[:3]
    for dx, dy, dz, w in _corner_weights(coords - lo):
        ix = np.clip(lo[:, 0] + dx, 0, shape[0] - 1)
        iy = np.clip(lo[:, 1] + dy, 0, shape[1] - 1)
        iz = np.clip(lo[:, 2] + dz, 0, shape[2] - 1)
        if grid.ndim == 4:
            np.add.at(grid, (ix, iy, iz), values * w[:, None])
        else:
            np.add.at(grid, (ix, iy, iz), values * w)


def _grid_frame(pts: np.ndarray, res: int):
    """Common bounding-box -> grid mapping: (origin, spacing)."""
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    center = (lo + hi) / 2
    span = float((hi - lo).max()) * 1.1 + 1e-9
    spacing = span / (res - 1)
    origin = center - span / 2
    return origin, spacing


def _screen_diag(density: np.ndarray, screen: float) -> np.ndarray | None:
    """Screening diagonal from the splat density: normalized so the mean
    occupied node gets weight ``screen`` (making alpha resolution- and
    point-count-independent, in the spirit of Kazhdan-Hoppe's
    area-normalized screening)."""
    if screen <= 0:
        return None
    occ = density > 0
    if not occ.any():
        return None
    return (screen / float(density[occ].mean())) * density


def _poisson_system(pts: np.ndarray, nrm: np.ndarray, res: int, origin: np.ndarray,
                    spacing: float, screen: float = 0.0):
    """The dense grid Poisson system on the host: splat normals, divergence.
    Returns (b = -div V, the screening diagonal or None, density), each a
    (res, res, res) array.

    ``screen > 0`` gives the system of the SCREENED Poisson equation
    (-lap + alpha·D) chi = -div V with D the (normalized) sample splat
    density — the pointwise interpolation penalty of Kazhdan-Hoppe 2013
    with lumped-diagonal weights and target chi(sample) = 0. This is
    what the reference's Open3D call actually runs
    (the reference's `pointcloud_to_mesh.py:356-366`); the unscreened
    equation over-smooths and bulges on open-boundary depth-map clouds
    (dense foreground, sparse background)."""
    coords = (pts - origin) / spacing
    V = np.zeros((res, res, res, 3), np.float32)
    density = np.zeros((res, res, res), np.float32)
    _splat_trilinear(V, coords, nrm)
    _splat_trilinear(density, coords, np.ones(len(pts)))

    # divergence by central differences
    div = np.zeros((res, res, res))
    for axis in range(3):
        comp = V[..., axis]
        grad = np.zeros_like(comp)
        sl_f = [slice(None)] * 3
        sl_b = [slice(None)] * 3
        sl_c = [slice(None)] * 3
        sl_f[axis] = slice(2, None)
        sl_b[axis] = slice(0, -2)
        sl_c[axis] = slice(1, -1)
        grad[tuple(sl_c)] = (comp[tuple(sl_f)] - comp[tuple(sl_b)]) / 2.0
        div += grad

    return -div, _screen_diag(density, screen), density


def _dense_chi(pts: np.ndarray, nrm: np.ndarray, res: int, origin: np.ndarray,
               spacing: float, cg_iters: int, screen: float = 0.0, device="cuda"):
    """Dense grid Poisson solve: the system on the host, then the CG of
    (-lap [+ alpha·D])(chi) = -div V (SPD form) on ``device``, where a
    device error raises (no host fallback). Returns (chi, density) as
    (res, res, res) arrays."""
    b, diag, density = _poisson_system(pts, nrm, res, origin, spacing, screen)
    return _poisson_cg_device(b, iters=cg_iters, diag=diag, device=device), density


def _density_filter(mesh_verts, faces, vdens, density_quantile):
    """Drop vertices in the bottom density quantile (reference behavior:
    remove_vertices_by_mask(densities < quantile(0.1)))."""
    keep = vdens >= np.quantile(vdens, density_quantile)
    keep_idx = np.nonzero(keep)[0]
    remap = -np.ones(len(mesh_verts), dtype=np.int64)
    remap[keep_idx] = np.arange(len(keep_idx))
    face_ok = keep[faces].all(axis=1)
    faces = remap[faces[face_ok]]
    return TriangleMesh(mesh_verts[keep_idx], faces).cleanup()


def poisson_reconstruct(points: np.ndarray, normals: np.ndarray, depth: int = 6,
                        density_quantile: float = 0.1, cg_iters: int = 300,
                        screen: float = 4.0, device="cuda"):
    """Grid Poisson surface reconstruction (see module docstring).

    ``depth`` mirrors the reference's octree depth: grid resolution is
    2**depth per axis. Up to depth 8 (256^3, the reference's octree
    default, `pointcloud_to_mesh.py:356-366`) the solve is a dense grid
    CG on ``device``; depth >= 9 switches to the sparse
    narrow-band solver (`poisson_reconstruct_sparse`) — a dense 512^3+
    grid would not fit host memory, and the surface only occupies a thin
    shell of it anyway.

    ``screen`` is the Kazhdan-Hoppe screening weight (the reference's
    Open3D Poisson is *screened*; its default interpolation weight is 4).
    0 disables screening (the plain Poisson equation, round-2 behavior).
    """
    pts = np.asarray(points, dtype=np.float64)
    nrm = np.asarray(normals, dtype=np.float64)
    if len(pts) < 4:
        return TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    if 2**depth > 256:
        return poisson_reconstruct_sparse(
            pts, nrm, depth=depth, density_quantile=density_quantile,
            cg_iters=cg_iters, screen=screen, device=device)
    res = 2**depth

    origin, spacing = _grid_frame(pts, res)
    coords = (pts - origin) / spacing
    chi, density = _dense_chi(pts, nrm, res, origin, spacing, cg_iters,
                              screen=screen, device=device)

    # iso level: mean indicator value at the sample points
    ijk = np.clip(np.round(coords).astype(np.int64), 0, res - 1)
    iso = float(np.mean(chi[ijk[:, 0], ijk[:, 1], ijk[:, 2]]))

    verts, faces = marching_tetrahedra(chi, iso, origin, spacing)
    if len(verts) == 0:
        return TriangleMesh(verts, faces)

    vcoords = np.clip(np.round((verts - origin) / spacing).astype(np.int64), 0, res - 1)
    vdens = density[vcoords[:, 0], vcoords[:, 1], vcoords[:, 2]]
    return _density_filter(verts, faces, vdens, density_quantile)


# ---------------------------------------------------------------------------
# sparse narrow-band Poisson (depth >= 9)


def _trilinear_sample(grid: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Clamped trilinear sampling of a (n, n, n) grid at float coords (N, 3)."""
    n = grid.shape[0]
    c = np.clip(coords, 0.0, n - 1.0)
    lo = np.minimum(np.floor(c).astype(np.int64), n - 2)
    out = np.zeros(len(c), dtype=np.float64)
    for dx, dy, dz, w in _corner_weights(c - lo):
        out += w * grid[lo[:, 0] + dx, lo[:, 1] + dy, lo[:, 2] + dz]
    return out


def _decode(keys: np.ndarray, res: int):
    iz = keys % res
    iy = (keys // res) % res
    ix = keys // (res * res)
    return ix, iy, iz


def _neighbor_keys(keys: np.ndarray, res: int):
    """(M, 6) neighbor keys along ±x, ±y, ±z; -1 where out of grid."""
    ix, iy, iz = _decode(keys, res)
    out = np.empty((len(keys), 6), dtype=np.int64)
    for col, (dx, dy, dz) in enumerate(
        [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    ):
        nx, ny, nz = ix + dx, iy + dy, iz + dz
        valid = (nx >= 0) & (nx < res) & (ny >= 0) & (ny < res) & (nz >= 0) & (nz < res)
        out[:, col] = np.where(valid, (nx * res + ny) * res + nz, -1)
    return out


def _splat_sparse(keys: np.ndarray, res: int, coords: np.ndarray,
                  values: np.ndarray) -> np.ndarray:
    """Trilinear splat onto the compacted node set ``keys`` (sorted).
    values: (N,) or (N, C). Contributions to nodes outside ``keys`` are
    dropped (they are zero by construction when keys ⊇ splat support)."""
    out_shape = (len(keys),) + values.shape[1:]
    out = np.zeros(out_shape, dtype=np.float64)
    lo = np.floor(coords).astype(np.int64)
    for dx, dy, dz, w in _corner_weights(coords - lo):
        ix = np.clip(lo[:, 0] + dx, 0, res - 1)
        iy = np.clip(lo[:, 1] + dy, 0, res - 1)
        iz = np.clip(lo[:, 2] + dz, 0, res - 1)
        k = (ix * res + iy) * res + iz
        pos = np.searchsorted(keys, k)
        pos_c = np.minimum(pos, len(keys) - 1)
        found = keys[pos_c] == k
        if values.ndim == 2:
            np.add.at(out, pos_c[found], values[found] * w[found, None])
        else:
            np.add.at(out, pos_c[found], values[found] * w[found])
    return out


def poisson_reconstruct_sparse(points: np.ndarray, normals: np.ndarray,
                               depth: int = 9, density_quantile: float = 0.1,
                               cg_iters: int = 300, band: int | None = None,
                               coarse_depth: int = 8, screen: float = 4.0,
                               device="cuda"):
    """Narrow-band Poisson reconstruction for depth >= 9 (512^3+).

    Beyond-reference fidelity (the reference's Open3D call runs octree
    depth 8, `pointcloud_to_mesh.py:356-366`): a dense solve at
    ``coarse_depth`` (on ``device``) provides global topology and
    Dirichlet boundary values; the indicator is then re-solved at full
    resolution only on a narrow band of grid nodes around the samples
    (matrix-free CG over a compacted node set — the dense 512^3 grid
    would be 0.5 GB per scalar field, but the band is ~1-3% of it).
    Marching tetrahedra runs over band cells only.
    """
    pts = np.asarray(points, dtype=np.float64)
    nrm = np.asarray(normals, dtype=np.float64)
    if len(pts) < 4:
        return TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    res = 2**depth
    origin, spacing = _grid_frame(pts, res)
    coords = (pts - origin) / spacing

    # --- band: splat-support nodes dilated until sample gaps bridge
    lo = np.floor(coords).astype(np.int64)
    corner = lo[:, None, :] + _CUBE_OFFSETS[None, :, :]
    corner = np.clip(corner, 0, res - 1)
    keys = np.unique((corner[..., 0] * res + corner[..., 1]) * res + corner[..., 2])
    if band is None:
        # Size the band to bridge sample gaps so marching (which only
        # visits band cells) doesn't skip iso-crossings between samples.
        # Use a high quantile of per-sample neighbor distance, not the
        # mean — locally sparse regions (depth-map clouds: dense
        # foreground, sparse background) set the requirement. Extremely
        # non-uniform clouds can still need an explicit ``band``.
        from scipy.spatial import cKDTree

        sel = np.random.default_rng(0).choice(len(pts), min(1000, len(pts)), replace=False)
        k = min(9, len(pts))
        dist, _ = cKDTree(pts).query(pts[sel], k=k, workers=-1)
        gap = float(np.quantile(dist[:, 1:].mean(axis=1), 0.9)) if k > 1 else spacing
        band = max(3, int(np.ceil(gap / spacing)) + 2)
    for _ in range(band - 1):
        nb = _neighbor_keys(keys, res)
        keys = np.unique(np.concatenate([keys, nb[nb >= 0]]))
    m = len(keys)

    # --- sparse splat of the normal field + sample density
    V = _splat_sparse(keys, res, coords, nrm)
    density = _splat_sparse(keys, res, coords, np.ones(len(pts)))

    # neighbor table into the compacted set; sentinel m = outside band
    nb_keys = _neighbor_keys(keys, res)
    pos = np.searchsorted(keys, np.where(nb_keys >= 0, nb_keys, 0))
    pos_c = np.minimum(pos, m - 1)
    in_band = (nb_keys >= 0) & (keys[pos_c] == nb_keys)
    nb_idx = np.where(in_band, pos_c, m).astype(np.int64)  # (M, 6)

    # divergence by central differences (V=0 outside the splat support,
    # which lies strictly inside the band)
    def read(col, arr):
        pad = np.concatenate([arr, np.zeros((1,) + arr.shape[1:])])
        return pad[nb_idx[:, col]]

    div = (
        (read(0, V)[:, 0] - read(1, V)[:, 0])
        + (read(2, V)[:, 1] - read(3, V)[:, 1])
        + (read(4, V)[:, 2] - read(5, V)[:, 2])
    ) / 2.0

    # --- coarse dense solve for boundary values / initial guess
    cres = min(2**coarse_depth, 256)
    cspacing = spacing * (res - 1) / (cres - 1)
    chi_c, _ = _dense_chi(pts, nrm, cres, origin, cspacing, cg_iters,
                          screen=screen, device=device)
    ratio = (cres - 1) / (res - 1)

    def coarse_at(node_keys: np.ndarray) -> np.ndarray:
        ijk = np.stack(_decode(node_keys, res), axis=1).astype(np.float64)
        return _trilinear_sample(chi_c, ijk * ratio)

    # Lattice scaling: both paths splat RAW normals and use UNIT-spacing
    # stencils, so for a grid of spacing h the node field is V ~ n·σ·h²
    # (points within one cell of a node), the unit-lattice divergence
    # adds another h, and the unit-lattice Laplacian absorbs h² — the
    # discrete indicator therefore scales as chi_d ∝ h. Converting the
    # coarse solution to the fine lattice: chi_f = (h_f/h_c)·chi_c =
    # ratio·chi_c.
    scale = ratio
    chi_bc_all = coarse_at(keys) * scale

    # Dirichlet contributions: for each missing neighbor, its coarse value
    b = -div
    x0 = chi_bc_all.copy()
    for col in range(6):
        missing = ~in_band[:, col] & (nb_keys[:, col] >= 0)
        if missing.any():
            b[missing] += coarse_at(nb_keys[missing, col]) * scale
        # out-of-grid neighbors keep the zero (far-field) boundary

    # screening diagonal on band nodes (density ~ 0 at the band edge, so
    # the coarse-to-fine h-scaling transfer of the Dirichlet values — a
    # pure-Laplacian-region argument — is unaffected by screening)
    diag = _screen_diag(density, screen)

    def apply_A(x):
        pad = np.concatenate([x, [0.0]])
        acc = 6.0 * x if diag is None else (6.0 + diag) * x
        for col in range(6):
            acc -= pad[nb_idx[:, col]]
        return acc

    # CG with the coarse solution as the initial guess
    r = b - apply_A(x0)
    p = r.copy()
    rs = float(r @ r)
    b_norm = np.sqrt(float(b @ b)) + 1e-30
    x = x0
    for _ in range(cg_iters):
        Ap = apply_A(p)
        alpha = rs / (float(p @ Ap) + 1e-30)
        x = x + alpha * p
        r -= alpha * Ap
        rs_new = float(r @ r)
        if np.sqrt(rs_new) / b_norm < 1e-6:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    chi = x

    # iso level: mean indicator at the sample nodes
    ijk = np.clip(np.round(coords).astype(np.int64), 0, res - 1)
    skeys = (ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2]
    spos = np.minimum(np.searchsorted(keys, skeys), m - 1)
    iso = float(np.mean(chi[spos]))

    # --- marching tetrahedra over band cells only
    ix, iy, iz = _decode(keys, res)
    cell_ok = (ix < res - 1) & (iy < res - 1) & (iz < res - 1)
    base_keys = keys[cell_ok]
    bx, by, bz = _decode(base_keys, res)
    cbase = np.stack([bx, by, bz], axis=1)
    corner_idx = cbase[:, None, :] + _CUBE_OFFSETS[None, :, :]  # (C, 8, 3)
    ckeys = (corner_idx[..., 0] * res + corner_idx[..., 1]) * res + corner_idx[..., 2]
    cpos = np.minimum(np.searchsorted(keys, ckeys.ravel()), m - 1)
    cfound = keys[cpos] == ckeys.ravel()
    cvals = np.where(cfound, chi[cpos], 0.0)
    if not cfound.all():
        cvals[~cfound] = coarse_at(ckeys.ravel()[~cfound]) * scale
    cvals = cvals.reshape(-1, 8)
    inside = cvals > iso
    straddle = inside.any(axis=1) & ~inside.all(axis=1)
    if not straddle.any():
        return TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    corner_pos = origin + corner_idx[straddle] * spacing
    verts, faces = _march_cells(cvals[straddle], corner_pos, iso, spacing)
    if len(verts) == 0:
        return TriangleMesh(verts, faces)

    # density filter via the sparse density (0 outside the band)
    vijk = np.clip(np.round((verts - origin) / spacing).astype(np.int64), 0, res - 1)
    vkeys = (vijk[:, 0] * res + vijk[:, 1]) * res + vijk[:, 2]
    vpos = np.minimum(np.searchsorted(keys, vkeys), m - 1)
    vdens = np.where(keys[vpos] == vkeys, density[vpos], 0.0)
    return _density_filter(verts, faces, vdens, density_quantile)


# ---------------------------------------------------------------------------
# direct triangulations


def simple_triangulation(cloud: PointCloud, k: int = 6) -> TriangleMesh:
    """Reference 'simple' method: fan triangles over k nearest neighbors
    (`pointcloud_to_mesh.py:423-465`), vectorized."""
    from scipy.spatial import cKDTree

    pts = cloud.points
    if len(pts) < 3:
        return TriangleMesh(pts.copy(), np.zeros((0, 3), np.int64),
                            None if cloud.colors is None else cloud.colors.copy())
    tree = cKDTree(pts)
    # clamp k: cKDTree pads missing neighbors with index == n, which
    # would put a nonexistent vertex into faces
    _, idx = tree.query(pts, k=min(k + 1, len(pts)), workers=-1)
    nbrs = idx[:, 1:]
    k = nbrs.shape[1]  # face construction below emits k-1 fan pairs
    i = np.repeat(np.arange(len(pts)), k - 1)
    a = nbrs[:, :-1].ravel()
    b = nbrs[:, 1:].ravel()
    faces = np.column_stack([i, a, b])
    return TriangleMesh(pts.copy(), faces, None if cloud.colors is None else cloud.colors.copy()).cleanup()


def ball_pivoting(cloud: PointCloud, radii: list | None = None) -> TriangleMesh:
    """TRUE Ball-Pivoting reconstruction (Bernardini et al.) via the
    native kernel (native/bpa.cpp), radii from the sampled average
    k-NN distance x {2, 4, 8, 16} exactly like the reference's Open3D
    call (`pointcloud_to_mesh.py:368-375`). Falls back to the tangent-
    fan approximation when the native library is unavailable.

    On a 20k-point unit sphere: exactly 2n-4 triangles, watertight
    (0 boundary edges, 0 non-manifold edges), 2 s on one host core.
    """
    pts = cloud.points
    if len(pts) < 3:
        return TriangleMesh(pts.copy(), np.zeros((0, 3), np.int64),
                            None if cloud.colors is None else cloud.colors.copy())
    if radii is None:
        avg = average_point_distance(pts)
        radii = [avg * 2, avg * 4, avg * 8, avg * 16]
    try:
        from ..native import neighbors as _native

        if _native.available():
            normals = estimate_normals(pts, radius=float(radii[0]))
            faces = _native.bpa_reconstruct(pts, normals, radii)
            return TriangleMesh(
                pts.copy(), faces,
                None if cloud.colors is None else cloud.colors.copy(),
            ).cleanup()
        reason = "native geometry library unavailable"
    except Exception as exc:  # pragma: no cover - fall through to the stand-in
        reason = f"native BPA failed: {exc!r}"
    logger.warning(
        "ball_pivoting: %s; falling back to the tangent-fan approximation "
        "(structurally different mesh)", reason)
    return tangent_fan_triangulation(cloud, radius=float(radii[1]) if radii else None)


def tangent_fan_triangulation(cloud: PointCloud, radius: float | None = None,
                              k: int = 10) -> TriangleMesh:
    """Tangent-plane fan triangulation (fallback when the native BPA
    kernel is unavailable): order each point's neighbors by angle in
    the local tangent plane and emit radius-limited fan triangles."""
    from scipy.spatial import cKDTree

    pts = cloud.points
    if radius is None:
        radius = average_point_distance(pts) * 4
    normals = estimate_normals(pts, radius)
    tree = cKDTree(pts)
    dist, idx = tree.query(pts, k=min(k + 1, len(pts)), workers=-1)

    faces = []
    for i in range(len(pts)):
        nbrs = idx[i, 1:][dist[i, 1:] <= radius]
        if len(nbrs) < 2:
            continue
        n = normals[i]
        # tangent basis
        t1 = np.cross(n, [1.0, 0.0, 0.0])
        if np.linalg.norm(t1) < 1e-6:
            t1 = np.cross(n, [0.0, 1.0, 0.0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        rel = pts[nbrs] - pts[i]
        ang = np.arctan2(rel @ t2, rel @ t1)
        order = nbrs[np.argsort(ang)]
        for j in range(len(order)):
            a, b = order[j], order[(j + 1) % len(order)]
            if i < a and i < b:  # emit each fan corner once
                faces.append([i, a, b])
    faces = np.asarray(faces, dtype=np.int64) if faces else np.zeros((0, 3), np.int64)
    return TriangleMesh(pts.copy(), faces,
                        None if cloud.colors is None else cloud.colors.copy()).cleanup()


def depth_map_mesh(depth: np.ndarray, f_px: float, image: np.ndarray | None = None,
                   step: int = 2, max_edge_ratio: float = 0.05) -> TriangleMesh:
    """Structured mesh straight from a depth map: grid vertices at every
    ``step``-th pixel, two triangles per cell, edges cut at depth
    discontinuities (legacy capability: the textured/video3d mesh
    builders of `OLD_SCRIPTS/mesh_from_depth.py:2312-2606`).

    ``max_edge_ratio``: drop faces whose corner depths differ by more
    than this fraction of their mean (removes streaks across silhouettes).
    """
    d = np.asarray(depth, dtype=np.float64)[::step, ::step]
    h, w = d.shape
    full_h, full_w = depth.shape
    ys, xs = np.indices((h, w))
    px = xs * step
    py = ys * step
    x3 = -(px - full_w / 2.0) * d / f_px
    y3 = -(py - full_h / 2.0) * d / f_px
    verts = np.column_stack([x3.ravel(), y3.ravel(), d.ravel()])

    idx = np.arange(h * w).reshape(h, w)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    dd = idx[1:, 1:].ravel()
    faces = np.concatenate([np.column_stack([a, b, c]), np.column_stack([c, b, dd])])

    # cut faces across strong depth discontinuities
    dv = verts[:, 2]
    f_depths = dv[faces]
    mean_d = f_depths.mean(axis=1)
    spread = f_depths.max(axis=1) - f_depths.min(axis=1)
    keep = spread <= max_edge_ratio * np.maximum(mean_d, 1e-9)
    # drop invalid-depth faces as well
    keep &= np.isfinite(f_depths).all(axis=1) & (f_depths > 0).all(axis=1)
    faces = faces[keep]

    colors = None
    if image is not None:
        img = np.asarray(image)[::step, ::step].astype(np.float64)
        # accept grayscale (H, W) and RGBA alongside RGB, like the rest
        # of the image-consuming stack (native _rgb_image, depth_to_3d)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        elif img.shape[-1] == 4:
            img = img[..., :3]
        if img.max() > 1.0:
            img = img / 255.0
        colors = img.reshape(-1, 3)
    return TriangleMesh(verts, faces, colors).cleanup()


def add_ground_plane_mesh(mesh: TriangleMesh, y: float = 0.0,
                          margin: float = 0.5, cells: int = 20,
                          color=(0.5, 0.5, 0.5)) -> TriangleMesh:
    """Append a synthetic ground-plane grid under the mesh footprint
    (legacy capability: `OLD_SCRIPTS/mesh_from_depth.py:880` ground-plane
    mesh synthesis)."""
    if len(mesh.vertices) == 0:
        return mesh
    lo = mesh.vertices.min(axis=0) - margin
    hi = mesh.vertices.max(axis=0) + margin
    xs = np.linspace(lo[0], hi[0], cells + 1)
    zs = np.linspace(lo[2], hi[2], cells + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.column_stack([gx.ravel(), np.full(gx.size, y), gz.ravel()])
    idx = np.arange((cells + 1) * (cells + 1)).reshape(cells + 1, cells + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate([np.column_stack([a, b, c]), np.column_stack([c, b, d])])
    off = len(mesh.vertices)
    colors = mesh.vertex_colors
    if colors is not None:
        colors = np.vstack([colors, np.tile(color, (len(verts), 1))])
    return TriangleMesh(
        np.vstack([mesh.vertices, verts]),
        np.vstack([mesh.faces, faces + off]),
        colors,
    )


# ---------------------------------------------------------------------------
# public entry


def create_mesh_from_pointcloud(cloud: PointCloud, voxel_size: float = 0.05,
                                depth: int = 8, method: str = "poisson",
                                screen: float = 4.0, device="cuda") -> TriangleMesh:
    """Point cloud -> mesh (reference entry `pointcloud_to_mesh.py:313`).
    ``screen`` = Kazhdan-Hoppe screening weight for the poisson method
    (4.0 mirrors Open3D's screened-Poisson default; 0 = unscreened);
    ``device`` is where the poisson method's dense CG runs."""
    down = voxel_downsample(cloud, voxel_size)
    if method == "poisson":
        normals = estimate_normals(down.points, radius=voxel_size * 2)
        mesh = poisson_reconstruct(down.points, normals, depth=depth,
                                   screen=screen, device=device)
        if down.colors is not None and len(mesh.vertices):
            from scipy.spatial import cKDTree

            _, nearest = cKDTree(down.points).query(mesh.vertices, k=1, workers=-1)
            mesh.vertex_colors = down.colors[nearest]
        return mesh
    if method == "ball_pivoting":
        return ball_pivoting(down)
    if method == "simple":
        return simple_triangulation(down)
    raise ValueError(
        f"Unknown mesh creation method: {method}. Use 'poisson', 'ball_pivoting', or 'simple'."
    )
