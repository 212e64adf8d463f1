"""The port's surface reconstruction (``geom/mesh.py``) against the JAX
package's, on the CPU.

The Poisson solve is the one piece that is not a copy: the JAX package runs
its conjugate gradient under ``jax.jit``, the port in PyTorch ops on the
caller's device (here ``cpu``). On the same right-hand side and screening
diagonal both solve in fp32 in the same operation order, and only the sums'
order differs, so the indicator agrees within ``CHI_BOUND`` of its largest
magnitude (9.3e-6 measured on the sphere below). The inside/outside split
of the grid at the iso level is then identical, and so are the mesh counts,
except that the unscreened 64^3 solve splits one vertex more at the vertex
dedupe lattice of ``_march_cells`` (faces equal). The host part is a copy
and must equal the JAX package's bit for bit. Then every case of
``tests/test_mesh.py`` runs against the port, with the one deliberate
difference: where the JAX package falls back to a host CG when the device
solve fails, the port raises.
"""

import inspect
import logging
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ml_depth_pro_video_tpu.geom import mesh as jmesh
from ml_depth_pro_video_tpu.geom.pointcloud import PointCloud as JPointCloud
from ml_depth_pro_video_tpu_torch.geom import mesh as tmesh
from ml_depth_pro_video_tpu_torch.geom.mesh import (
    TriangleMesh,
    average_point_distance,
    create_mesh_from_pointcloud,
    estimate_normals,
    marching_tetrahedra,
    poisson_reconstruct,
    simple_triangulation,
    voxel_downsample,
)
from ml_depth_pro_video_tpu_torch.geom.pointcloud import PointCloud
from ml_depth_pro_video_tpu_torch.native import neighbors as tnative

CHI_BOUND = 1e-4  # max |chi_port - chi_jax| over max |chi_jax|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def sphere_cloud(n=4000, r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r


@pytest.fixture(scope="module")
def sphere():
    """6000 points on the unit sphere with outward normals."""
    pts = sphere_cloud(6000)
    return pts, -jmesh.estimate_normals(pts, radius=0.3, camera=(0, 0, 0))


def _jax_solve(monkeypatch, pts, nrm, res, screen):
    """JAX's ``_dense_chi`` at ``res``; returns (the right-hand side and
    screening diagonal it handed its device CG, its chi, density, grid)."""
    seen = {}
    real = jmesh._poisson_cg_device

    def spy(b, iters=300, tol=1e-6, diag=None):
        seen.update(b=b, diag=diag, iters=iters)
        return real(b, iters, tol, diag)

    monkeypatch.setattr(jmesh, "_poisson_cg_device", spy)
    origin, spacing = jmesh._grid_frame(pts, res)
    chi, density = jmesh._dense_chi(pts, nrm, res, origin, spacing, 300, screen=screen)
    return seen, chi, density, origin, spacing


def _iso(chi, pts, origin, spacing):
    res = chi.shape[0]
    ijk = np.clip(np.round((pts - origin) / spacing).astype(np.int64), 0, res - 1)
    return float(np.mean(chi[ijk[:, 0], ijk[:, 1], ijk[:, 2]]))


@pytest.mark.parametrize("screen", [0.0, 4.0])
@pytest.mark.parametrize("res", [32, 64])
def test_poisson_cg_matches_jax(monkeypatch, sphere, res, screen):
    pts, nrm = sphere
    seen, chi_j, dens_j, origin, spacing = _jax_solve(monkeypatch, pts, nrm, res, screen)
    assert (seen["diag"] is None) == (screen == 0.0)
    got = tmesh._poisson_cg_device(seen["b"], iters=seen["iters"], diag=seen["diag"],
                                   device="cpu")
    assert got.dtype == np.float64 and got.shape == (res,) * 3
    assert np.abs(got - chi_j).max() <= CHI_BOUND * np.abs(chi_j).max()

    # the port's own _dense_chi: the same splat (bit for bit) and the same solve
    chi_t, dens_t = tmesh._dense_chi(pts, nrm, res, origin, spacing, 300, screen=screen,
                                     device="cpu")
    np.testing.assert_array_equal(dens_t, dens_j)
    np.testing.assert_array_equal(chi_t, got)
    iso_j, iso_t = _iso(chi_j, pts, origin, spacing), _iso(chi_t, pts, origin, spacing)
    np.testing.assert_array_equal(chi_t > iso_t, chi_j > iso_j)
    vj, fj = jmesh.marching_tetrahedra(chi_j, iso_j, origin, spacing)
    vt, ft = tmesh.marching_tetrahedra(chi_t, iso_t, origin, spacing)
    assert len(ft) == len(fj)
    # unscreened 64^3: one pair of coincident edge points rounds to two keys
    assert abs(len(vt) - len(vj)) <= (1 if screen == 0.0 and res == 64 else 0)


@pytest.mark.parametrize("depth", [5, 6])
def test_poisson_reconstruct_counts_match_jax(sphere, depth):
    """The default (screened) reconstruction: equal counts, and every vertex
    within 1e-3 of the grid spacing of one of JAX's."""
    pts, nrm = sphere
    want = jmesh.poisson_reconstruct(pts, nrm, depth=depth)
    got = poisson_reconstruct(pts, nrm, depth=depth, device="cpu")
    assert (len(got.vertices), len(got.faces)) == (len(want.vertices), len(want.faces))
    _, spacing = jmesh._grid_frame(pts, 2**depth)
    assert _nearest(got.vertices, want.vertices).max() <= 1e-3 * spacing


def _nearest(a, b):
    """Symmetric nearest-neighbour distance between two vertex sets."""
    return np.concatenate([cKDTree(b).query(a)[0], cKDTree(a).query(b)[0]])


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("tol", [1e-6, 1e-3])
def test_cg_exit_freezes_the_iterate(monkeypatch, sphere, check_every, tol):
    """Reading the exit test every ``CG_CHECK_EVERY`` iterations runs idle
    iterations past the exit but returns the same iterate, bit for bit, and
    counts the same iterations as testing before every one."""
    pts, nrm = sphere
    seen, *_ = _jax_solve(monkeypatch, pts, nrm, 32, 4.0)
    b = torch.as_tensor(seen["b"].astype(np.float32))
    d = torch.as_tensor(seen["diag"].astype(np.float32))
    x8, n8 = tmesh._poisson_cg(b, d, 300, tol)
    monkeypatch.setattr(tmesh, "CG_CHECK_EVERY", check_every)
    x, n = tmesh._poisson_cg(b, d, 300, tol)
    assert n == n8 and 0 < n < 300
    assert torch.equal(x, x8)
    # one iteration fewer gives another iterate: the count is where the loop stopped
    x_short, _ = tmesh._poisson_cg(b, d, n - 1, tol)
    assert not torch.equal(x_short, x)
    x_long, n_long = tmesh._poisson_cg(b, d, n + 5, tol)
    assert n_long == n and torch.equal(x_long, x)


def test_cg_zero_rhs_runs_no_iteration():
    x, n = tmesh._poisson_cg(torch.zeros((8, 8, 8)), None, 300, 1e-6)
    assert n == 0 and not x.any()


def test_device_error_raises_without_fallback(monkeypatch, caplog):
    """The port's counterpart of ``test_poisson_cg_fallback_warns``: a failing
    device solve propagates; nothing solves again on the host."""
    def boom(b, iters, diag, device):
        raise RuntimeError("synthetic device OOM")

    monkeypatch.setattr(tmesh, "_poisson_cg_device", boom)
    pts = sphere_cloud(800)
    normals = estimate_normals(pts, radius=0.3, camera=(0, 0, 0))
    with caplog.at_level(logging.WARNING, logger="ml_depth_pro_video_tpu_torch.geom.mesh"):
        with pytest.raises(RuntimeError, match="synthetic device OOM"):
            tmesh.poisson_reconstruct(pts, -normals, depth=4, cg_iters=60, device="cpu")
    assert not caplog.records


@pytest.mark.skipif(torch.cuda.is_available(), reason="asks for a card that is absent")
def test_missing_card_raises():
    pts = sphere_cloud(800)
    normals = estimate_normals(pts, radius=0.3, camera=(0, 0, 0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        poisson_reconstruct(pts, -normals, depth=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_mesh_from_pointcloud(PointCloud(pts), voxel_size=0.1, depth=4)


@pytest.mark.parametrize("fn", [tmesh._poisson_cg_device, tmesh._dense_chi,
                                tmesh.poisson_reconstruct, tmesh.poisson_reconstruct_sparse,
                                create_mesh_from_pointcloud])
def test_solve_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# the host part: a copy, equal to the JAX package's bit for bit


def _mesh_equal(got, want):
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    if want.vertex_colors is None:
        assert got.vertex_colors is None
    else:
        np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)


def _depth_scene(h=60, w=80, f=70.0, seed=0):
    """A floor, a back wall at 5 m and a box face at 3 m, 1% noise."""
    rng = np.random.default_rng(seed)
    yd = (np.arange(h) - h / 2.0)[:, None] / f * np.ones((1, w))
    xd = (np.arange(w) - w / 2.0)[None, :] / f * np.ones((h, 1))
    depth = np.full((h, w), 5.0)
    floor = yd > 1e-3
    depth[floor] = np.minimum(depth[floor], 1.5 / yd[floor])
    depth[(np.abs(xd * 3.0) < 0.5) & (yd * 3.0 > 0.5)] = 3.0
    depth *= 1.0 + 0.01 * rng.standard_normal(depth.shape)
    return depth, rng.integers(0, 256, (h, w, 3), dtype=np.uint8), f


@pytest.mark.parametrize("native_on", [True, False])
def test_host_functions_equal_jax(native_on):
    """voxel_downsample, estimate_normals, simple and BPA triangulation, the
    tangent fan, marching tetrahedra, the depth-map mesh and the ground
    plane: one input, both packages, native C++ and numpy routes."""
    if native_on and not (tnative.available() and jmesh._native.available()):
        pytest.skip("native lib unavailable")
    pts = sphere_cloud(1500, seed=3)
    cols = np.random.default_rng(4).random((1500, 3))
    off = [mock.patch.object(m._native, "available", lambda: False) for m in (jmesh, tmesh)]
    for p in ([] if native_on else off):
        p.start()
    try:
        jd = jmesh.voxel_downsample(JPointCloud(pts, cols), 0.05)
        td = voxel_downsample(PointCloud(pts, cols), 0.05)
        np.testing.assert_array_equal(td.points, jd.points)
        np.testing.assert_array_equal(td.colors, jd.colors)
        np.testing.assert_array_equal(estimate_normals(pts, 0.3), jmesh.estimate_normals(pts, 0.3))
        assert average_point_distance(pts) == jmesh.average_point_distance(pts)
        _mesh_equal(simple_triangulation(PointCloud(pts, cols)),
                    jmesh.simple_triangulation(JPointCloud(pts, cols)))
        _mesh_equal(tmesh.ball_pivoting(PointCloud(pts, cols)),
                    jmesh.ball_pivoting(JPointCloud(pts, cols)))
        _mesh_equal(tmesh.tangent_fan_triangulation(PointCloud(pts[:400])),
                    jmesh.tangent_fan_triangulation(JPointCloud(pts[:400])))
    finally:
        for p in ([] if native_on else off):
            p.stop()
    g = np.linspace(-1.5, 1.5, 24)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    values = 1.0 - np.sqrt(x**2 + y**2 + (1.3 * z) ** 2)
    for got, want in zip(marching_tetrahedra(values, 0.1, np.full(3, -1.5), g[1] - g[0]),
                         jmesh.marching_tetrahedra(values, 0.1, np.full(3, -1.5), g[1] - g[0])):
        np.testing.assert_array_equal(got, want)
    depth, image, f = _depth_scene()
    dm = tmesh.depth_map_mesh(depth, f, image=image, step=2)
    _mesh_equal(dm, jmesh.depth_map_mesh(depth, f, image=image, step=2))
    jdm = jmesh.depth_map_mesh(depth, f, image=image, step=2)
    _mesh_equal(tmesh.add_ground_plane_mesh(dm, y=-1.5, cells=6),
                jmesh.add_ground_plane_mesh(jdm, y=-1.5, cells=6))


def test_sparse_poisson_counts_match_jax(sphere):
    """The narrow-band solver is host numpy in both packages; its coarse dense
    solve is the device CG, so the two agree within the CG's rounding."""
    pts, nrm = sphere
    want = jmesh.poisson_reconstruct_sparse(pts, nrm, depth=5, coarse_depth=4)
    got = tmesh.poisson_reconstruct_sparse(pts, nrm, depth=5, coarse_depth=4, device="cpu")
    assert (len(got.vertices), len(got.faces)) == (len(want.vertices), len(want.faces))
    _, spacing = jmesh._grid_frame(pts, 32)
    assert _nearest(got.vertices, want.vertices).max() <= 1e-3 * spacing


# ---------------------------------------------------------------------------
# every case of tests/test_mesh.py, against the port


def test_marching_tetrahedra_sphere_isosurface():
    res = 32
    g = np.linspace(-1.5, 1.5, res)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    values = 1.0 - np.sqrt(x**2 + y**2 + z**2)  # iso=0 at radius 1
    spacing = g[1] - g[0]
    verts, faces = marching_tetrahedra(values, 0.0, np.array([-1.5, -1.5, -1.5]), spacing)
    assert len(verts) > 500 and len(faces) > 500
    radii = np.linalg.norm(verts, axis=1)
    np.testing.assert_allclose(radii.mean(), 1.0, atol=0.05)
    assert radii.std() < 0.05
    assert faces.max() < len(verts) and faces.min() >= 0


def test_estimate_normals_sphere_point_outward_or_inward():
    pts = sphere_cloud(2000)
    normals = estimate_normals(pts, radius=0.3, camera=(0, 0, 0))
    cos = np.einsum("ij,ij->i", normals, -pts)
    assert (cos > 0.9).mean() > 0.95


def test_poisson_reconstruct_sphere():
    pts = sphere_cloud(6000)
    normals = estimate_normals(pts, radius=0.3, camera=(0, 0, 0))
    mesh = poisson_reconstruct(pts, -normals, depth=5, device="cpu")
    assert len(mesh.vertices) > 200
    radii = np.linalg.norm(mesh.vertices, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.15


def test_poisson_sparse_matches_dense_and_refines():
    pts = sphere_cloud(3000)
    normals = estimate_normals(pts, radius=0.3, camera=(0, 0, 0))

    def median_err(mesh):
        r = np.linalg.norm(mesh.vertices, axis=1)
        return np.median(np.abs(r - 1.0))

    dense = poisson_reconstruct(pts, -normals, depth=5, device="cpu")
    sparse_same = tmesh.poisson_reconstruct_sparse(pts, -normals, depth=5, coarse_depth=4,
                                                   device="cpu")
    sparse_fine = tmesh.poisson_reconstruct_sparse(pts, -normals, depth=6, coarse_depth=5,
                                                   device="cpu")
    e_dense, e_same, e_fine = median_err(dense), median_err(sparse_same), median_err(sparse_fine)
    assert abs(e_same - e_dense) < 0.02
    assert len(sparse_same.faces) > 0.5 * len(dense.faces)
    assert e_fine < e_dense + 1e-4
    assert len(sparse_fine.vertices) > 2 * len(dense.vertices)


def test_poisson_depth9_dispatches_to_sparse(monkeypatch):
    called = {}

    def fake_sparse(pts, nrm, depth, density_quantile, cg_iters, screen, device):
        called["depth"], called["device"] = depth, device
        return TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))

    monkeypatch.setattr(tmesh, "poisson_reconstruct_sparse", fake_sparse)
    tmesh.poisson_reconstruct(sphere_cloud(100), sphere_cloud(100), depth=9, device="cpu")
    assert called == {"depth": 9, "device": "cpu"}


def test_voxel_downsample_counts():
    cloud = PointCloud(sphere_cloud(5000), np.full((5000, 3), 0.5))
    down = voxel_downsample(cloud, 0.2)
    assert 0 < len(down) < 5000
    np.testing.assert_allclose(down.colors, 0.5)


def test_simple_triangulation_and_cleanup():
    mesh = simple_triangulation(PointCloud(sphere_cloud(300)))
    assert len(mesh.faces) > 100
    key = np.sort(mesh.faces, axis=1)
    assert len(np.unique(key, axis=0)) == len(key)


@pytest.mark.parametrize("method", ["poisson", "ball_pivoting", "simple"])
def test_create_mesh_end_to_end_methods(method):
    cloud = PointCloud(sphere_cloud(3000), np.random.default_rng(0).uniform(size=(3000, 3)))
    mesh = create_mesh_from_pointcloud(cloud, voxel_size=0.1, depth=5, method=method,
                                       device="cpu")
    assert len(mesh.vertices) > 50
    assert len(mesh.faces) > 50
    if method == "poisson":
        assert mesh.vertex_colors is not None
    with pytest.raises(ValueError, match="Unknown mesh creation method"):
        create_mesh_from_pointcloud(cloud, method="marching", device="cpu")


def test_average_point_distance():
    pts = np.stack(np.meshgrid(*([np.arange(5.0)] * 3), indexing="ij"), -1).reshape(-1, 3)
    assert 0.9 < average_point_distance(pts, k=6) < 2.0


def test_obj_save(tmp_path):
    mesh = TriangleMesh(np.eye(3), np.array([[0, 1, 2]]), np.ones((3, 3)) * 0.5)
    p = str(tmp_path / "m.obj")
    mesh.save_obj(p)
    assert "v 1.000000" in open(p).read()


def test_add_ground_plane_mesh():
    base = TriangleMesh(np.array([[0.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 1.0]]),
                        np.array([[0, 1, 2]]), np.ones((3, 3)))
    out = tmesh.add_ground_plane_mesh(base, y=0.0, cells=4)
    assert len(out.vertices) == 3 + 25
    assert len(out.faces) == 1 + 32
    np.testing.assert_allclose(out.vertices[3:, 1], 0.0)


def test_depth_map_mesh():
    depth = np.full((40, 60), 5.0)
    depth[:, 30:] = 10.0
    img = np.full((40, 60, 3), 200, np.uint8)
    mesh = tmesh.depth_map_mesh(depth, f_px=100.0, image=img, step=2)
    assert len(mesh.vertices) > 400
    assert len(mesh.faces) > 400
    assert mesh.vertex_colors is not None
    zd = mesh.vertices[mesh.faces][..., 2]
    assert (zd.max(axis=1) - zd.min(axis=1)).max() < 1.0


def _edge_stats(faces):
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    key = e[:, 0].astype(np.int64) * (10 ** 7) + e[:, 1]
    _, cnt = np.unique(key, return_counts=True)
    return int((cnt == 1).sum()), int((cnt > 2).sum())


def test_ball_pivoting_sphere_watertight():
    if not tnative.available():
        pytest.skip("native lib unavailable")
    n = 2000
    cloud = PointCloud(sphere_cloud(n), None)
    mesh = tmesh.ball_pivoting(cloud)
    boundary, nonmani = _edge_stats(mesh.faces)
    assert len(mesh.faces) == 2 * n - 4
    assert boundary == 0 and nonmani == 0
    fan = tmesh.tangent_fan_triangulation(cloud)
    fan_boundary, _ = _edge_stats(fan.faces)
    assert len(mesh.faces) > len(fan.faces) or boundary < fan_boundary


def test_ball_pivoting_fallback_warns(monkeypatch, caplog):
    monkeypatch.setattr(tnative, "available", lambda: False)
    v = sphere_cloud(200, seed=1)
    with caplog.at_level(logging.WARNING, logger="ml_depth_pro_video_tpu_torch.geom.mesh"):
        mesh = tmesh.ball_pivoting(PointCloud(v, None))
    assert len(mesh.faces) > 0
    assert any("tangent-fan" in r.message for r in caplog.records)


def test_poisson_degenerate_inputs_return_empty():
    for n in (0, 1, 3):
        m = poisson_reconstruct(np.zeros((n, 3)), np.zeros((n, 3)), depth=9, device="cpu")
        assert len(m.faces) == 0
        m = tmesh.poisson_reconstruct_sparse(np.zeros((n, 3)), np.zeros((n, 3)), depth=5,
                                             device="cpu")
        assert len(m.faces) == 0


def test_bpa_threading_exact_determinism(monkeypatch):
    if not tnative.available():
        pytest.skip("native lib unavailable")
    n = 1500
    cloud = PointCloud(sphere_cloud(n, seed=1), None)
    monkeypatch.setenv("BPA_THREADS", "1")
    m1 = tmesh.ball_pivoting(cloud)
    monkeypatch.setenv("BPA_THREADS", "5")
    m5 = tmesh.ball_pivoting(cloud)
    assert np.array_equal(m1.faces, m5.faces)
    assert len(m1.faces) == 2 * n - 4


def test_simple_triangulation_tiny_cloud():
    for n in (3, 4, 5):
        mesh = simple_triangulation(PointCloud(sphere_cloud(n)), k=6)
        if len(mesh.faces):
            assert mesh.faces.max() < len(mesh.vertices)


def test_native_normals_match_numpy_fallback():
    if not tnative.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(0)
    g = np.linspace(0, 1, 40)
    xx, zz = np.meshgrid(g, g)
    pts = np.column_stack([
        xx.ravel(), 0.08 * np.sin(6 * xx.ravel()) * np.cos(6 * zz.ravel()), zz.ravel()])
    pts += rng.normal(scale=1e-4, size=pts.shape)
    got = tnative.estimate_normals(pts, radius=0.12, camera=(0.5, 5.0, 0.5))
    with mock.patch.object(tmesh._native, "available", lambda: False):
        ref = tmesh.estimate_normals(pts, radius=0.12, camera=(0.5, 5.0, 0.5))
    dots = np.abs(np.einsum("ij,ij->i", got, ref))
    assert np.quantile(dots, 0.05) > 0.9995, np.quantile(dots, [0, 0.05, 0.5])


def test_estimate_normals_fallback_matches_per_point_loop():
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((500, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts = np.vstack([pts, [[10.0, 0, 0], [0, 20.0, 0]]])
    radius, camera, max_nn = 0.3, (0.0, 0.0, 0.0), 30
    with mock.patch.object(tmesh._native, "available", lambda: False):
        got = tmesh.estimate_normals(pts, radius, camera, max_nn)
    dist, idx = cKDTree(pts).query(pts, k=min(max_nn, len(pts)), workers=-1)
    ref = np.zeros_like(pts)
    for i in range(len(pts)):
        nbrs = idx[i][dist[i] <= radius]
        if len(nbrs) < 3:
            ref[i] = [0, 1, 0]
            continue
        q = pts[nbrs] - pts[nbrs].mean(axis=0)
        _, v = np.linalg.eigh(q.T @ q)
        ref[i] = v[:, 0]
    ref[np.einsum("ij,ij->i", ref, np.asarray(camera) - pts) < 0] *= -1
    np.testing.assert_allclose(got, ref, atol=1e-8)


def test_estimate_normals_fallback_speed_100k():
    import time

    pts = np.random.default_rng(0).random((100_000, 3)) * 5.0
    with mock.patch.object(tmesh._native, "available", lambda: False):
        t0 = time.perf_counter()
        normals = tmesh.estimate_normals(pts, radius=0.15, camera=(0, 0, 0))
        dt = time.perf_counter() - t0
    assert normals.shape == pts.shape
    assert np.all(np.isfinite(normals))
    assert dt < 20.0, f"vectorized fallback took {dt:.1f}s on 100k points"


def test_screened_poisson_room_scene(monkeypatch):
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from scripts.poisson_room_validation import room_depth_cloud, scene_distance

    pts, _ = room_depth_cloud(h=96, w=120, f=110.0)
    pts = pts + np.random.default_rng(0).normal(scale=2e-3, size=pts.shape)
    normals = estimate_normals(pts, radius=0.2, camera=(0.0, 0.0, 0.0))
    stats = {}
    tree = cKDTree(pts)
    for screen in (0.0, 4.0):
        mesh = poisson_reconstruct(pts, -normals, depth=6, screen=screen, device="cpu")
        assert len(mesh.faces) > 500
        near = tree.query(mesh.vertices, k=1, workers=-1)[0] < 0.15
        v2s = scene_distance(mesh.vertices[near])
        stats[screen] = (float(np.mean(v2s)), float(np.quantile(v2s, 0.95)))
    assert stats[4.0][0] <= stats[0.0][0] * 1.1, stats
    assert stats[4.0][1] < stats[0.0][1], stats


def test_precision_script_runs(capsys):
    """``scripts/torch_poisson_precision.py`` at 32^3 on the CPU: three solves,
    the float64 one the reference."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_poisson_precision.py"
    spec = importlib.util.spec_from_file_location("torch_poisson_precision", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--res", "32", "--devices", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum("iterations in" in line for line in lines) == 3
    errs = [float(line.split("max |diff| ")[1].split()[0]) for line in lines if "against" in line]
    assert len(errs) == 3 and max(errs) < CHI_BOUND
