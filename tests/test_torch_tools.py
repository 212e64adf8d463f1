"""The port's host tool layer against the JAX package's, on the CPU: the
depth-space shadow removal (``geom/depth_shadows.py``), the point-cloud floor
plans (``geom/floorplan.py``, ``depth-pro-ply-floorplan-torch``), the HTML
viewers (``geom/html_viewer.py``), the metrics (``eval/*``,
``depth-pro-eval-torch``), the viewer CLI (``depth-pro-view-torch``) and the
four CLIs that run the model (``depth-pro-pointcloud-torch``, ``-clean-``,
``-mesh-``, ``-floorplan-torch``).

The host modules are copies, so on one scene they must equal the JAX
package's bit for bit, files included. The four runner CLIs run in both
packages on a stub runner that hands both the same ``infer_one`` result (a
ray-cast room): their PLY and PNG files must be equal byte for byte, and the
Poisson mesh (the one solve that is not a copy) must have the same counts and
99.9% of its vertices within ``MESH_ATOL`` grid spacings of one of JAX's
(every one within twice that). Then each
package's own tiny fp32 runner, both on one npz of weights: depth within the
JAX package's parity bar (rtol 1e-3 / atol 1e-4) and every file written.
Every case of ``tests/test_depth_shadows.py``, ``tests/test_floorplan.py``
and ``tests/test_eval.py`` runs against the port, as do the viewer cases of
``tests/test_cli_drivers.py``; the seven ``main`` entry points run with
``--device cpu`` where they have it (the runner class replaced by a stub).
"""

import base64
import dataclasses
import inspect
import json
import os
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

import chip_smoke
from ml_depth_pro_video_tpu.cli import (
    depth_to_floorplan as j_floorplan_cli,
    img_to_pointcloud as j_pointcloud_cli,
    pointcloud_cleaner as j_clean_cli,
    pointcloud_to_mesh as j_mesh_cli,
    view_pointcloud as j_view_cli,
)
from ml_depth_pro_video_tpu.eval import (
    boundary_metrics as j_boundary,
    depth_metrics as j_depth_metrics,
    temporal_metrics as j_temporal,
)
from ml_depth_pro_video_tpu.geom import (
    depth_shadows as j_shadows,
    floorplan as j_floorplan,
    html_viewer as j_html,
    mesh as j_mesh,
    pointcloud as j_pc,
)
from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.cli import (
    depth_to_floorplan as t_floorplan_cli,
    eval_depth as t_eval_cli,
    img_to_pointcloud as t_pointcloud_cli,
    pointcloud_cleaner as t_clean_cli,
    pointcloud_to_mesh as t_mesh_cli,
    view_pointcloud as t_view_cli,
)
from ml_depth_pro_video_tpu_torch.eval import (
    boundary_metrics as t_boundary,
    depth_metrics as t_depth_metrics,
    temporal_metrics as t_temporal,
)
from ml_depth_pro_video_tpu_torch.eval.boundary_metrics import (
    SI_boundary_F1,
    SI_boundary_Recall,
    boundary_f1,
    fgbg_depth,
    nms_horizontal,
    nms_vertical,
)
from ml_depth_pro_video_tpu_torch.eval.depth_metrics import compute_all
from ml_depth_pro_video_tpu_torch.geom import (
    floorplan as t_floorplan,
    html_viewer as t_html,
    mesh as t_mesh,
)
from ml_depth_pro_video_tpu_torch.geom.depth_shadows import (
    find_depth_shadows,
    force_horizontal_ground,
    ground_depth_along_rays,
    remove_depth_shadows,
)
from ml_depth_pro_video_tpu_torch.geom.floorplan import (
    Polygon2D,
    create_density_grid,
    create_direct_floorplan,
    create_height_slices,
    detect_floor_plane,
    normalize_points_to_floor,
    pointcloud_to_floorplan,
)
from ml_depth_pro_video_tpu_torch.geom.pointcloud import PointCloud, read_ply, write_ply
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.native import neighbors as t_native
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint

RTOL, ATOL = 1e-3, 1e-4  # the JAX package's parity bar (tests/test_depth_pro_parity.py:50)
MESH_ATOL = 1e-3  # Poisson mesh vertices, in grid spacings
SCENE_H, SCENE_W, SCENE_F = 120, 160, 125.0  # chip_smoke's room at 1/12 of 1080x1920
MESH_DEPTH = 6  # 64^3: the CLI's default 256^3 is the card's (chip_smoke phase tools)
JAX = SimpleNamespace(pointcloud=j_pointcloud_cli, clean=j_clean_cli, mesh=j_mesh_cli,
                      floorplan=j_floorplan_cli)
PORT = SimpleNamespace(pointcloud=t_pointcloud_cli, clean=t_clean_cli, mesh=t_mesh_cli,
                       floorplan=t_floorplan_cli)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_files(a: Path, b: Path, names) -> None:
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


# ---------------------------------------------------------------------------
# geom/depth_shadows.py


def scene_depth(h=80, w=100, f=100.0):
    """``tests/test_depth_shadows.py``'s scene: a camera above the ground
    plane y=-1 looking forward."""
    ys, xs = np.indices((h, w))
    dir_y = -(ys - h / 2.0) / f
    with np.errstate(divide="ignore"):
        z = np.where(dir_y < 0, 1.0 / -dir_y, 10.0)
    return np.clip(z, 0.5, 10.0)


FLAT = {"normal": np.array([0.0, 1.0, 0.0]), "d": 1.0, "origin": np.zeros(3)}


@pytest.mark.parametrize("ground", [None, "flat"])
def test_depth_shadows_equal_jax(ground):
    """On a room (chip_smoke's structured scene, blurred edges): the mask, the
    filled depth and the ground model equal the JAX package's bit for bit,
    with a given ground and with the one it fits."""
    scene = chip_smoke.structured_scene(SCENE_H, SCENE_W, SCENE_F, 3)
    depth = scene["depth"].astype(np.float64)
    model = None if ground is None else dict(FLAT)
    for kw in (dict(interpolate_ground=True), dict(interpolate_ground=False),
               dict(force_horizontal=True, threshold_factor=0.3)):
        got = remove_depth_shadows(depth, f_px=SCENE_F, ground_model=model, seed=1, **kw)
        want = j_shadows.remove_depth_shadows(depth, f_px=SCENE_F, ground_model=model, seed=1,
                                              **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert json.dumps(got[2], default=list) == json.dumps(want[2], default=list)
    np.testing.assert_array_equal(find_depth_shadows(depth, 0.2, 50),
                                  j_shadows.find_depth_shadows(depth, 0.2, 50))
    tilted = {"normal": np.array([0.3, 0.9, 0.1]), "d": -1.0, "origin": np.array([0, 1.0, 0])}
    for kw in (dict(max_angle=5.0), dict(completely_flat=True)):
        a = force_horizontal_ground(tilted, **kw)
        b = j_shadows.force_horizontal_ground(tilted, **kw)
        np.testing.assert_array_equal(a["normal"], b["normal"])
        assert a["d"] == b["d"]
    np.testing.assert_array_equal(ground_depth_along_rays((40, 50), 45.0, FLAT),
                                  j_shadows.ground_depth_along_rays((40, 50), 45.0, FLAT))


def test_find_depth_shadows_flags_discontinuity():
    shadowed = scene_depth()
    shadowed[30:34, 40:44] = 2.0
    mask = find_depth_shadows(shadowed, threshold_factor=0.2, min_region_size=200)
    assert mask[31, 41]
    assert mask[70:75, 10:90].mean() < 0.2


def test_force_horizontal_ground():
    model = {"normal": np.array([0.3, 0.9, 0.0]), "d": -1.0,
             "origin": np.array([0.0, 1.0, 0.0])}
    out = force_horizontal_ground(model, max_angle=5.0)
    ang = np.degrees(np.arccos(np.clip(out["normal"] @ np.array([0, 1, 0.0]), -1, 1)))
    assert ang <= 5.0 + 1e-6
    flat = force_horizontal_ground(model, completely_flat=True)
    np.testing.assert_allclose(flat["normal"], [0, 1, 0])


def test_ground_depth_along_rays_matches_plane():
    model = {"normal": np.array([0.0, 1.0, 0.0]), "d": 2.0, "origin": np.zeros(3)}
    z = ground_depth_along_rays((40, 40), 50.0, model)
    v, u = 35, 20
    np.testing.assert_allclose(z[v, u], -2.0 / (-(v - 20.0) / 50.0))
    assert np.isnan(z[5, 20])


def test_remove_depth_shadows_fills_with_ground():
    shadowed = scene_depth()
    shadowed[60:63, 40:70] = 1.0
    out, mask, gm = remove_depth_shadows(shadowed, f_px=100.0, ground_model=dict(FLAT),
                                         threshold_factor=0.3, min_region_size=400)
    assert mask[61, 50]
    assert out[61, 50] > 2.0


def test_remove_depth_shadows_never_emits_nan_and_keeps_off_ground():
    shadowed = scene_depth()
    shadowed[60:63, 40:70] = 1.0
    shadowed[5:8, 40:70] = 1.0
    out, mask, _ = remove_depth_shadows(shadowed, f_px=100.0, ground_model=dict(FLAT),
                                        threshold_factor=0.3, min_region_size=400)
    assert np.isfinite(out).all()
    assert (out >= 0.1).all()
    if mask[6, 50]:
        assert out[6, 50] == shadowed[6, 50]
    same, _, _ = remove_depth_shadows(shadowed, f_px=100.0, ground_model=dict(FLAT),
                                      interpolate_ground=False, threshold_factor=0.3,
                                      min_region_size=400)
    np.testing.assert_array_equal(same, shadowed)


def test_force_horizontal_ground_exact_angle():
    n = np.array([np.sin(np.radians(30)), np.cos(np.radians(30)), 0.0])
    model = {"normal": n, "d": -1.0, "origin": np.array([0.0, 1.0, 0.0])}
    out = force_horizontal_ground(model, max_angle=5.0)
    ang = np.degrees(np.arccos(np.clip(out["normal"] @ [0, 1, 0], -1, 1)))
    np.testing.assert_allclose(ang, 5.0, atol=1e-9)


# ---------------------------------------------------------------------------
# geom/floorplan.py and depth-pro-ply-floorplan-torch


def room_scene(seed=0, n_floor=6000, n_wall=3000):
    """``tests/test_floorplan.py``'s room: a floor, one wall and one box, 3° tilt."""
    rng = np.random.default_rng(seed)
    floor = np.column_stack([rng.uniform(0, 6, n_floor), rng.normal(0, 0.01, n_floor),
                             rng.uniform(0, 6, n_floor)])
    wall = np.column_stack([rng.uniform(0, 6, n_wall), rng.uniform(0, 2.4, n_wall),
                            np.full(n_wall, 6.0) + rng.normal(0, 0.01, n_wall)])
    box = np.column_stack([rng.uniform(2, 3, 1500), rng.uniform(0, 1.0, 1500),
                           rng.uniform(2, 3, 1500)])
    a = np.radians(3.0)
    R = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    return np.vstack([floor, wall, box]) @ R.T


def test_floorplan_functions_equal_jax(tmp_path):
    pts = room_scene()
    model, inliers = detect_floor_plane(PointCloud(pts), distance_threshold=0.03, seed=1)
    j_model, j_inliers = j_floorplan.detect_floor_plane(j_pc.PointCloud(pts),
                                                        distance_threshold=0.03, seed=1)
    assert model == j_model
    np.testing.assert_array_equal(inliers, j_inliers)
    flat = normalize_points_to_floor(pts, model)
    np.testing.assert_array_equal(flat, j_floorplan.normalize_points_to_floor(pts, model))
    for kw in (dict(num_slices=5), dict(height_threshold=1.3)):
        got = create_height_slices(flat, None, **kw)
        want = j_floorplan.create_height_slices(flat, None, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    for got, want in zip(create_density_grid(flat[:, [0, 2]], 0.05),
                         j_floorplan.create_density_grid(flat[:, [0, 2]], 0.05)):
        np.testing.assert_array_equal(got, want)
    for kw in (dict(height_threshold=None), dict(height_threshold=0.5, simplified=False)):
        img = create_direct_floorplan(flat, str(tmp_path / "t.png"), **kw)
        np.testing.assert_array_equal(
            img, j_floorplan.create_direct_floorplan(flat, str(tmp_path / "j.png"), **kw))
        assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_pointcloud_to_floorplan_equal_jax(tmp_path):
    """The four outputs of ``depth-pro-ply-floorplan``: the polygon txt and the
    cv2 plan equal byte for byte, the two matplotlib figures pixel for pixel."""
    pts = room_scene()
    ply = str(tmp_path / "room.ply")
    write_ply(ply, PointCloud(pts, np.full_like(pts, 0.5)))
    got = pointcloud_to_floorplan(ply, str(tmp_path / "port"), num_slices=3)
    want = j_floorplan.pointcloud_to_floorplan(ply, str(tmp_path / "jax"), num_slices=3)
    assert got.keys() == want.keys()
    for key in ("data", "direct"):
        assert Path(got[key]).read_bytes() == Path(want[key]).read_bytes(), key
    for key in ("floorplan", "simple"):
        np.testing.assert_array_equal(np.asarray(Image.open(got[key])),
                                      np.asarray(Image.open(want[key])))


def test_polygon2d_area():
    sq = Polygon2D(np.array([[0, 0], [2, 0], [2, 3], [0, 3]], float))
    assert sq.area == 6.0
    assert sq.centroid.tolist() == [1.0, 1.5]


def test_detect_floor_plane_recovers_tilt():
    pts = room_scene()
    (a, b, c, d), inliers = detect_floor_plane(PointCloud(pts), distance_threshold=0.03, seed=1)
    normal = np.array([a, b, c]) * (1 if b > 0 else -1)
    assert np.degrees(np.arccos(np.clip(normal[1], -1, 1))) < 6.0
    assert len(inliers) > 3000
    flat = normalize_points_to_floor(pts, (a, b, c, d))
    assert abs(np.median(flat[inliers, 1])) < 0.05


def test_height_slices():
    pts = room_scene()
    slices = create_height_slices(pts, None, num_slices=5)
    assert len(slices) == 5
    assert sum(len(s["points"]) for s in slices) > 1000
    assert len(create_height_slices(pts, None, height_threshold=1.3)) == 1


def test_density_grid():
    grid, origin, res = create_density_grid(np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]]), 0.5,
                                            padding=0.0)
    assert grid.sum() == 3
    assert grid.max() == 2


def test_full_floorplan_pipeline(tmp_path):
    pts = room_scene()
    ply = str(tmp_path / "room.ply")
    write_ply(ply, PointCloud(pts, np.full_like(pts, 0.5)))
    outs = pointcloud_to_floorplan(ply, str(tmp_path), num_slices=3)
    for key, path in outs.items():
        assert os.path.exists(path), key
        assert os.path.getsize(path) > 0, key
    data = open(outs["data"]).read()
    assert "# Format: height, num_points, x1, z1, x2, z2, ...\n" in data
    rows = [line for line in data.splitlines() if line and not line.startswith("#")]
    assert rows
    heights = []
    for row in rows:
        fields = [float(v) for v in row.split(", ")]
        assert len(fields) == 2 + 2 * int(fields[1])
        heights.append(fields[0])
    assert heights == sorted(heights)


def test_direct_floorplan_height_threshold(tmp_path):
    p = str(tmp_path / "direct.png")
    img = create_direct_floorplan(room_scene(), p, height_threshold=1.3)
    assert img.shape[2] == 3
    assert os.path.exists(p)


def test_native_splat_matches_numpy():
    import ml_depth_pro_video_tpu_torch.geom.floorplan_viz as fv

    if not t_native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    n = 60000
    pts = np.column_stack([rng.uniform(-4, 4, n), rng.uniform(0, 3, n), rng.uniform(1, 9, n)])
    pts[: n // 4, 1] = np.round(pts[: n // 4, 1], 2)
    for cols in (rng.uniform(size=(n, 3)), None):
        cloud = PointCloud(pts, cols)
        kw = dict(height_threshold=0.1, x_limits=(-4, 4), z_limits=(1, 9), width=512)
        a = fv.fast_floorplan_image(cloud, None, **kw)
        saved, fv._native = fv._native, None
        try:
            b = fv.fast_floorplan_image(cloud, None, **kw)
        finally:
            fv._native = saved
        np.testing.assert_array_equal(a, b)
    bad = pts.copy()
    bad[5, 1] = np.nan
    img = fv.fast_floorplan_image(PointCloud(bad), None, x_limits=(-4, 4), z_limits=(1, 9),
                                  width=128)
    assert img.shape[1] == 128


def test_ply_floorplan_cli(tmp_path, capsys):
    pts = room_scene()
    ply = str(tmp_path / "room.ply")
    write_ply(ply, PointCloud(pts, np.full_like(pts, 0.5)))
    t_floorplan.main([ply, "-o", str(tmp_path / "out"), "--num_slices", "3", "--fast"])
    printed = dict(line.split(": ", 1) for line in capsys.readouterr().out.strip().splitlines())
    assert sorted(printed) == ["data", "direct", "floorplan", "simple"]
    assert all(os.path.getsize(p) > 0 for p in printed.values())


# ---------------------------------------------------------------------------
# geom/html_viewer.py and depth-pro-view-torch


def test_html_viewers_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    cols = rng.random((500, 3)).astype(np.float32)
    for kw in (dict(), dict(max_points=100), dict(title="t<est>", point_size=3)):
        for c in (cols, None):
            t_html.export_html(PointCloud(pts, c), str(tmp_path / "t.html"), **kw)
            j_html.export_html(j_pc.PointCloud(pts, c), str(tmp_path / "j.html"), **kw)
            assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    mesh = t_mesh.depth_map_mesh(*_scene_depth_image(), step=4)
    t_html.export_mesh_html(mesh, str(tmp_path / "t.html"), title="m")
    j_html.export_mesh_html(j_mesh.TriangleMesh(mesh.vertices, mesh.faces, mesh.vertex_colors),
                            str(tmp_path / "j.html"), title="m")
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def _scene_depth_image():
    scene = chip_smoke.structured_scene(SCENE_H, SCENE_W, SCENE_F, 3)
    return scene["depth"], SCENE_F, scene["image"]


def test_html_viewer_export_payload_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    cols = rng.random((500, 3)).astype(np.float32)
    out = str(tmp_path / "cloud.html")
    t_html.export_html(PointCloud(pts, cols), out, title="t<est>")
    doc = open(out).read()
    assert "<canvas" in doc and "webgl" in doc
    assert "http://" not in doc and "https://" not in doc
    assert "t&lt;est&gt;" in doc
    pos_b64 = re.search(r'POS_B64 = "([^"]*)"', doc).group(1)
    col_b64 = re.search(r'COL_B64 = "([^"]*)"', doc).group(1)
    dec = np.frombuffer(base64.b64decode(pos_b64), np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(dec, pts)
    dec_c = np.frombuffer(base64.b64decode(col_b64), np.uint8).reshape(-1, 3)
    np.testing.assert_array_equal(dec_c, (np.clip(cols, 0, 1) * 255).astype(np.uint8))
    t_html.export_html(PointCloud(pts, cols), out, max_points=100)
    pos2 = re.search(r'POS_B64 = "([^"]*)"', open(out).read()).group(1)
    assert np.frombuffer(base64.b64decode(pos2), np.float32).reshape(-1, 3).shape == (100, 3)
    t_html.export_html(PointCloud(pts, None), out)
    col3 = re.search(r'COL_B64 = "([^"]*)"', open(out).read()).group(1)
    assert len(base64.b64decode(col3)) == 500 * 3


def test_mesh_html_viewer_export(tmp_path):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int64)
    n = t_html.vertex_normals(v, f)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-6)
    out = str(tmp_path / "tet.html")
    t_html.export_mesh_html(t_mesh.TriangleMesh(v, f, None), out, title="tet")
    doc = open(out).read()
    assert "drawElements" in doc
    assert "http://" not in doc and "https://" not in doc
    idx = np.frombuffer(base64.b64decode(re.search(r'IDX_B64 = "([^"]*)"', doc).group(1)),
                        np.uint32).reshape(-1, 3)
    np.testing.assert_array_equal(idx, f.astype(np.uint32))
    nrm = np.frombuffer(base64.b64decode(re.search(r'NRM_B64 = "([^"]*)"', doc).group(1)),
                        np.float32).reshape(-1, 3)
    np.testing.assert_allclose(nrm, n, rtol=1e-5, atol=1e-6)
    assert re.search(r'N_INDEX = (\d+)', doc).group(1) == "12"
    out2 = str(tmp_path / "pts.html")
    t_html.export_mesh_html(t_mesh.TriangleMesh(v, np.zeros((0, 3), np.int64), None), out2)
    assert 'N_INDEX = 0' in open(out2).read()


def test_view_pointcloud_cli_html(tmp_path):
    rng = np.random.default_rng(4)
    ply = str(tmp_path / "c.ply")
    write_ply(ply, PointCloud(rng.standard_normal((50, 3)), rng.random((50, 3))))
    t_view_cli.main([ply, "-o", str(tmp_path / "c.png"), "--html"])
    html_path = str(tmp_path / "c.html")
    assert os.path.exists(html_path)
    assert "drawArrays" in open(html_path).read()


@pytest.mark.parametrize("flags", [["--view", "front"], ["--view", "multi", "--width", "320",
                                                         "--height", "240"],
                                   ["--view", "floorplan", "--dpi", "50"],
                                   ["--html", "--height_threshold", "0.2"]])
def test_view_cli_equals_jax(tmp_path, flags):
    pts = room_scene(n_floor=1500, n_wall=800)
    ply = str(tmp_path / "room.ply")
    write_ply(ply, PointCloud(pts, np.random.default_rng(5).random(pts.shape)))
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        main = t_view_cli.main if pkg == "port" else j_view_cli.main
        main([ply, "-o", str(tmp_path / pkg / "v.png"), *flags])
    name = "v.html" if "--html" in flags else "v.png"
    _same_files(tmp_path / "port", tmp_path / "jax", [name])


# ---------------------------------------------------------------------------
# eval/* and depth-pro-eval-torch


def test_metrics_equal_jax():
    rng = np.random.default_rng(6)
    gt = np.ones((48, 64)) * 5
    gt[10:30, 20:40] = 1.5
    pred = gt * (1 + 0.05 * rng.standard_normal(gt.shape))
    mask = (gt < 2).astype(np.float64)
    assert t_depth_metrics.compute_all(pred, gt) == j_depth_metrics.compute_all(pred, gt)
    assert t_boundary.SI_boundary_F1(pred, gt) == j_boundary.SI_boundary_F1(pred, gt)
    assert t_boundary.SI_boundary_Recall(pred, mask) == j_boundary.SI_boundary_Recall(pred, mask)
    for fn in ("nms_horizontal", "nms_vertical"):
        np.testing.assert_array_equal(getattr(t_boundary, fn)(pred, 1.1),
                                      getattr(j_boundary, fn)(pred, 1.1))
    frames = [gt * (1 + 0.01 * rng.standard_normal(gt.shape)) for _ in range(5)]
    assert t_temporal.temporal_stability(frames) == j_temporal.temporal_stability(frames)


def nms_horizontal_oracle(ratio, threshold):
    """A per-run loop: the first maximum of each horizontal run."""
    mask = np.zeros_like(ratio, dtype=bool)
    r, c = np.nonzero(ratio > threshold)
    i = 0
    while i < len(r):
        j = i
        while j + 1 < len(r) and r[j + 1] == r[j] and c[j + 1] == c[j] + 1:
            j += 1
        vals = [ratio[r[k], c[k]] for k in range(i, j + 1)]
        k = i + int(np.argmax(vals))
        mask[r[k], c[k]] = True
        i = j + 1
    return mask


def test_nms_matches_oracle():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ratio = rng.uniform(0.9, 1.3, (12, 15))
        np.testing.assert_array_equal(nms_horizontal(ratio, 1.1),
                                      nms_horizontal_oracle(ratio, 1.1))


def test_nms_tie_breaks_to_first_max():
    mask = nms_horizontal(np.array([[2.0, 2.0, 2.0, 0.0, 2.0]]), 1.0)
    np.testing.assert_array_equal(mask, [[True, False, False, False, True]])


def test_nms_vertical_is_transpose():
    ratio = np.random.default_rng(1).uniform(0.9, 1.3, (9, 7))
    np.testing.assert_array_equal(nms_vertical(ratio, 1.1), nms_horizontal(ratio.T, 1.1).T)


def test_fgbg_depth_directions():
    left, top, right, bottom = fgbg_depth(np.array([[1.0, 3.0], [1.0, 1.0]]), 1.5)
    assert right[0, 0] and not left[0, 0]
    assert top[0, 1] and not bottom[0, 1]


def test_perfect_prediction_F1_is_1():
    depth = np.random.default_rng(2).uniform(1, 10, (32, 32))
    assert SI_boundary_F1(depth, depth) == 1.0


def test_boundary_f1_degrades_with_noise():
    rng = np.random.default_rng(3)
    gt = np.ones((64, 64)) * 5
    gt[20:40, 20:40] = 1.0
    assert SI_boundary_F1(gt, gt) > SI_boundary_F1(rng.uniform(1, 10, gt.shape), gt)


def test_recall_on_mask():
    depth = np.ones((32, 32)) * 5
    depth[10:20, 10:20] = 1.0
    mask = np.zeros((32, 32))
    mask[10:20, 10:20] = 1.0
    assert SI_boundary_Recall(depth, mask) > 0.5


def test_boundary_f1_zero_when_no_edges():
    edgy = np.ones((16, 16))
    edgy[:, 8:] = 10.0
    assert boundary_f1(np.ones((16, 16)), edgy, 1.1) == 0.0


def test_depth_metrics_identity():
    d = np.random.default_rng(4).uniform(1, 10, (16, 16))
    m = compute_all(d, d)
    assert m["abs_rel"] == 0 and m["rmse"] == 0 and m["delta1"] == 1.0
    worse = compute_all(d * 1.3, d)
    assert worse["abs_rel"] > 0.29 and worse["delta1"] < 1.0


def test_eval_depth_cli(tmp_path, capsys):
    rng = np.random.default_rng(0)
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i in range(2):
        gt = rng.uniform(1, 10, (24, 24))
        np.savez_compressed(gt_dir / f"frame{i}.npz", depth=gt)
        np.save(pred_dir / f"frame{i}_depth.npy", gt * (1.0 + 0.01 * i))
    t_eval_cli.main(["--pred", str(pred_dir), "--gt", str(gt_dir), "--per-image"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 3
    assert lines[-1]["n_images"] == 2
    assert lines[0]["abs_rel"] == 0.0
    assert 0.0 < lines[-1]["abs_rel"] < 0.01
    assert "SI_boundary_F1" in lines[-1]


def test_temporal_stability_metrics():
    from ml_depth_pro_video_tpu_torch.video.temporal import TemporalSmoother

    rng = np.random.default_rng(0)
    base = 2.0 + rng.random((32, 40)).astype(np.float32)
    noisy = [base * (1.0 + 0.01 * rng.standard_normal(base.shape).astype(np.float32))
             for _ in range(12)]
    raw = t_temporal.temporal_stability(noisy)
    assert raw["pairs"] == 11 and raw["frames"] == 12
    assert 0.005 < raw["flicker_mean"] < 0.03
    assert raw["static_fraction"] > 0.95
    sm = TemporalSmoother(alpha=0.8, align=False, device="cpu")
    out = t_temporal.temporal_stability([sm.update(d) for d in noisy])
    assert out["flicker_mean"] < raw["flicker_mean"] / 2
    p = t_temporal.pairwise_flicker(base, base * 1.03)
    np.testing.assert_allclose(p["scale_jitter"], np.log(1.03), rtol=1e-3)
    moved = base.copy()
    moved[8:16, 8:16] = 0.5
    p = t_temporal.pairwise_flicker(base, moved)
    assert p["flicker_mean"] == 0.0
    assert 0.9 < p["static_fraction"] < 1.0
    empty = t_temporal.temporal_stability([])
    assert empty["pairs"] == 0 and empty["flicker_mean"] == 0.0


def test_eval_cli_temporal_mode(tmp_path, capsys):
    rng = np.random.default_rng(1)
    base = 2.0 + rng.random((16, 16)).astype(np.float32)
    for i in (2, 10, 11):
        np.savez_compressed(tmp_path / f"frame_{i}_depth.npz", depth=base * (
            1 + 0.01 * rng.standard_normal(base.shape).astype(np.float32)))
    t_eval_cli.main(["--pred", str(tmp_path), "--temporal"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["frames"] == 3 and out["pairs"] == 2
    assert out["flicker_mean"] > 0
    with pytest.raises(SystemExit, match="must be a directory"):
        t_eval_cli.main(["--pred", str(tmp_path / "nope"), "--temporal"])


def test_eval_cli_temporal_dedups_colormap_twins(tmp_path, capsys):
    rng = np.random.default_rng(2)
    base = 2.0 + rng.random((16, 16)).astype(np.float32)
    for i in range(3):
        np.savez_compressed(tmp_path / f"frame_{i}_depth.npz", depth=base * (
            1 + 0.01 * rng.standard_normal(base.shape).astype(np.float32)))
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), np.uint8), "RGB").save(
            tmp_path / f"frame_{i}_depth.png")
    t_eval_cli.main(["--pred", str(tmp_path), "--temporal"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["frames"] == 3 and out["pairs"] == 2
    t_eval_cli.main(["--pred", str(tmp_path), "--temporal", "--pattern", "*_depth.npz"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["frames"] == 3 and out["pairs"] == 2


def test_eval_cli_equals_jax(tmp_path, capsys):
    from ml_depth_pro_video_tpu.cli import eval_depth as j_eval_cli

    scene = chip_smoke.structured_scene(SCENE_H, SCENE_W, SCENE_F, 3)
    gt = scene["depth"]
    np.savez_compressed(tmp_path / "room_gt.npz", depth=gt)
    np.savez_compressed(tmp_path / "room_depth.npz", depth=gt * (1 + 0.02 * np.random.default_rng(
        7).standard_normal(gt.shape)).astype(np.float32))
    argv = ["--pred", str(tmp_path / "room_depth.npz"), "--gt", str(tmp_path / "room_gt.npz")]
    t_eval_cli.main(argv)
    got = capsys.readouterr().out
    j_eval_cli.main(argv)
    assert got == capsys.readouterr().out
    assert all(np.isfinite(v) for v in json.loads(got).values() if isinstance(v, float))


# ---------------------------------------------------------------------------
# the four runner CLIs


class StubRunner:
    """Hands every ``infer_one`` the same result, as a runner on the CPU."""

    device = torch.device("cpu")

    def __init__(self, result):
        self.result = result
        self.calls = 0

    def infer_one(self, item):
        self.calls += 1
        return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in self.result.items()}


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """chip_smoke's ray-cast room at 120x160 as an ``infer_one`` result, and
    its PNG."""
    scene = chip_smoke.structured_scene(SCENE_H, SCENE_W, SCENE_F, 8)
    path = tmp_path_factory.mktemp("img") / "room_0001.png"
    Image.fromarray(scene["image"]).save(path)
    return {"depth": scene["depth"], "focallength_px": SCENE_F, "image": scene["image"]}, str(path)


def _run_cli(pkg, kind, image_path, out: Path, runner):
    """One runner CLI's function, as ``chip_smoke.py`` phase ``tools`` calls it."""
    out.mkdir(parents=True, exist_ok=True)
    if kind == "pointcloud":
        pkg.pointcloud.create_normalized_pointcloud(image_path, str(out / "cloud.ply"),
                                                    ground_params_dir=str(out), runner=runner)
        return ["cloud.ply", "ground.json"]
    if kind == "clean":
        pkg.clean.process_image_to_clean_pointcloud(image_path, str(out), runner=runner)
        return ["room_0001_clean.ply", "room_0001_clean_preview.png", "ground.json"]
    if kind == "floorplan":
        pkg.floorplan.depth_image_to_floorplan(image_path, str(out), runner=runner)
        return ["room_0001_floorplan.png", "ground.json"]
    pkg.mesh.process_image_to_mesh(image_path, str(out / "mesh.obj"), depth=MESH_DEPTH,
                                   runner=runner, html=True)
    return ["mesh.obj", "mesh.html", "mesh_preview.png", "room_0001_clean.ply", "ground.json"]


def _read_obj(path: Path):
    v, f = [], []
    for line in path.read_text().splitlines():
        if line.startswith("v "):
            v.append([float(t) for t in line.split()[1:4]])
        elif line.startswith("f "):
            f.append([int(t.split("/")[0]) for t in line.split()[1:4]])
    return np.asarray(v), np.asarray(f)


@pytest.mark.parametrize("kind", ["pointcloud", "clean", "floorplan", "mesh"])
def test_runner_clis_equal_jax_on_one_depth(tmp_path, room, kind):
    result, image_path = room
    stubs = {name: StubRunner(result) for name in ("port", "jax")}
    names = _run_cli(PORT, kind, image_path, tmp_path / "port", stubs["port"])
    assert _run_cli(JAX, kind, image_path, tmp_path / "jax", stubs["jax"]) == names
    assert stubs["port"].calls == stubs["jax"].calls == 1
    if kind != "mesh":
        _same_files(tmp_path / "port", tmp_path / "jax", names)
        return
    # the cleaned cloud (host code) byte for byte; the mesh within the solve's rounding
    _same_files(tmp_path / "port", tmp_path / "jax", ["room_0001_clean.ply", "ground.json"])
    (vt, ft), (vj, fj) = (_read_obj(tmp_path / p / "mesh.obj") for p in ("port", "jax"))
    assert len(vt) == len(vj) > 100 and len(ft) == len(fj) > 100
    cloud = read_ply(str(tmp_path / "port" / "room_0001_clean.ply"))
    down = t_mesh.voxel_downsample(cloud, 0.05)
    _, spacing = t_mesh._grid_frame(down.points, 2**MESH_DEPTH)
    gap = np.concatenate([cKDTree(vj).query(vt)[0], cKDTree(vt).query(vj)[0]]) / spacing
    # a vertex moves along its tet edge by the solves' chi difference over the edge's step in
    # chi, so a flat edge amplifies it: 2 of the 28,792 vertices sit 1.18e-3 and 1.31e-3
    # spacings from JAX's, the rest within MESH_ATOL (OBJ prints 6 decimals, ~1.5e-5 spacings)
    assert np.quantile(gap, 0.999) <= MESH_ATOL and gap.max() <= 2 * MESH_ATOL


@pytest.fixture(scope="module")
def tiny_runners(tmp_path_factory):
    ckpt = write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))
    port = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=ckpt),
                            precision="fp32", batch_size=1, decode_workers=1, device="cpu")
    jax = JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=ckpt),
                    precision="fp32", batch_size=1, decode_workers=1)
    return {"port": port, "jax": jax}


def test_runner_clis_on_tiny_runners(tmp_path, room, tiny_runners):
    """Each package's own tiny fp32 runner on one npz: the same depth within
    the parity bar, and every file of the four CLIs written."""
    _, image_path = room
    got = tiny_runners["port"].infer_one(image_path)
    want = tiny_runners["jax"].infer_one(image_path)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["focallength_px"], want["focallength_px"], rtol=RTOL)
    for pkg, name in ((PORT, "port"), (JAX, "jax")):
        for kind in ("pointcloud", "clean", "floorplan"):
            out = tmp_path / name / kind
            for f in _run_cli(pkg, kind, image_path, out, tiny_runners[name]):
                assert (out / f).stat().st_size > 0, (name, kind, f)
        # random weights frame kilometres: tests/test_cli_drivers.py's mesh settings
        out = tmp_path / name / "mesh"
        path, mesh = pkg.mesh.process_image_to_mesh(
            image_path, str(out / "mesh.obj"), method="simple", voxel_size=0.3, nb_points=3,
            radius=1.0, max_shadow_angle=0.0, runner=tiny_runners[name])
        assert os.path.getsize(path) > 0 and len(mesh.faces) > 10, name
        assert len(read_ply(str(tmp_path / name / "pointcloud" / "cloud.ply"))) > 1000


# ---------------------------------------------------------------------------
# the seven entry points


@pytest.fixture
def stub_class(monkeypatch, room):
    """Replace the port's runner class; record how each CLI builds it."""
    import ml_depth_pro_video_tpu_torch.video.runner as runner_mod

    built = []
    result = room[0]

    class Built(StubRunner):
        def __init__(self, **kw):
            super().__init__(result)
            built.append(kw)
            self.device = torch.device(kw["device"])

    monkeypatch.setattr(runner_mod, "DepthVideoRunner", Built)
    return built


def test_pointcloud_main(tmp_path, room, stub_class):
    out = str(tmp_path / "cloud.ply")
    t_pointcloud_cli.main(["--image_path", room[1], "--output_path", out, "--ground_params_dir",
                           str(tmp_path), "--grid_size", "10",
                           "--device", "cpu"])
    assert stub_class == [dict(precision="bf16", downscale_factor=1.0, device="cpu")]
    assert len(read_ply(out)) > 1000 and (tmp_path / "ground.json").exists()
    t_pointcloud_cli.main(["--image_path", room[1], "--output_path", str(tmp_path / "v.png"),
                           "--ground_params_dir", str(tmp_path), "--full_precision",
                           "--view", "top"])
    assert stub_class[1] == dict(precision="fp32", downscale_factor=1.0, device="cuda")
    assert (tmp_path / "v.png").stat().st_size > 0


def test_clean_main_flag_precedence(tmp_path, room, stub_class):
    t_clean_cli.main(["--image_path", room[1], "--output_dir", str(tmp_path), "--quality",
                      "fast", "--nb_points", "7", "--no_preview", "--device", "cpu"])
    # --quality fast sets downscale 0.3; the explicit --nb_points wins over its 25
    assert stub_class == [dict(precision="bf16", downscale_factor=0.3, device="cpu")]
    assert (tmp_path / "room_0001_clean.ply").exists()
    assert not (tmp_path / "room_0001_clean_preview.png").exists()


def test_mesh_main(tmp_path, room, stub_class, capsys):
    out = tmp_path / "m.obj"
    t_mesh_cli.main(["--image_path", room[1], "--output_path", str(out), "--quality", "fast",
                     "--depth", "5", "--html", "--device", "cpu"])
    assert stub_class == [dict(precision="bf16", downscale_factor=0.5, device="cpu")]
    assert "triangles" in capsys.readouterr().out
    for name in ("m.obj", "m.html", "m_preview.png"):
        assert (tmp_path / name).stat().st_size > 0, name
    t_mesh_cli.main(["--image_path", room[1], "--output_path", str(out), "--method", "simple",
                     "--voxel_size", "0.1", "--no_preview"])
    assert stub_class[1]["device"] == "cuda"  # the default


def test_floorplan_main(tmp_path, room, stub_class, capsys):
    t_floorplan_cli.main(["--image_path", room[1], "--output_dir", str(tmp_path),
                          "--height_threshold", "none", "--rot_y", "2", "--device", "cpu"])
    assert stub_class == [dict(precision="bf16", device="cpu")]
    assert capsys.readouterr().out.strip() == f"wrote {tmp_path / 'room_0001_floorplan.png'}"
    assert (tmp_path / "ground.json").exists()


@pytest.mark.parametrize("module", [t_pointcloud_cli, t_clean_cli, t_mesh_cli,
                                    t_floorplan_cli])
def test_runner_clis_default_to_the_card(module):
    fn = {t_pointcloud_cli: "create_normalized_pointcloud",
          t_clean_cli: "process_image_to_clean_pointcloud",
          t_mesh_cli: "process_image_to_mesh",
          t_floorplan_cli: "depth_image_to_floorplan"}[module]
    assert inspect.signature(getattr(module, fn)).parameters["device"].default == "cuda"


def test_host_clis_take_no_device(tmp_path):
    """``depth-pro-{view,ply-floorplan,eval}-torch`` do no device work."""
    for main in (t_view_cli.main, t_floorplan.main, t_eval_cli.main):
        with pytest.raises(SystemExit):
            main(["x", "--device", "cpu"] if main is not t_eval_cli.main
                 else ["--pred", "x", "--device", "cpu"])


# ---------------------------------------------------------------------------
# chip_smoke.py phase tools: its arithmetic and helpers on the CPU


def test_cg_bound_at_the_documented_grid():
    """One CG iteration moves at least 7 fp32 256^3 grids (x, r, p, d in; x,
    r, p out) screened, 6 unscreened: 0.1402 / 0.1202 ms at 3.35 TB/s."""
    assert round(chip_smoke.cg_bound_ms(256, True), 4) == 0.1402
    assert round(chip_smoke.cg_bound_ms(256, False), 4) == 0.1202
    assert chip_smoke.cg_bound_ms(128, True) * 8 == pytest.approx(chip_smoke.cg_bound_ms(256, True))


def test_bounded_plan_caps_the_raster(tmp_path):
    cells, seen = [], []

    def plan(points, output_path, **kwargs):
        seen.append(kwargs)
        return kwargs["grid_resolution"]

    bounded = chip_smoke.bounded_plan(plan, cells)
    far = np.array([[0.0, 1.0, 0.0], [10.0, 1.0, 4096.0 * 0.5], [0.0, 0.0, 1e6]])
    # the point below the height threshold is not drawn, so it does not set the cell
    assert bounded(far, "x.png", grid_resolution=0.05, height_threshold=0.5) == 1.0
    near = np.array([[0.0, 1.0, 0.0], [3.0, 1.0, 4.0]])
    assert bounded(near, "x.png", grid_resolution=0.05) == 0.05
    assert bounded(np.zeros((0, 3)), "x.png", grid_resolution=0.05) == 0.05
    assert cells == [1.0, 0.05, 0.05] and seen[0]["height_threshold"] == 0.5


def test_tools_phase_file_checks(tmp_path):
    mesh = t_mesh.TriangleMesh(np.eye(3), np.array([[0, 1, 2]]), np.ones((3, 3)))
    mesh.save_obj(str(tmp_path / "m.obj"))
    assert chip_smoke.read_obj_counts(tmp_path / "m.obj") == (3, 1)
    write_ply(str(tmp_path / "c.ply"), PointCloud(np.ones((5, 3))))
    assert chip_smoke.check_ply(tmp_path / "c.ply", "t") == 5
    write_ply(str(tmp_path / "bad.ply"), PointCloud(np.full((5, 3), np.nan)))
    with pytest.raises(AssertionError, match="finite False"):
        chip_smoke.check_ply(tmp_path / "bad.ply", "t")
    (tmp_path / "ground.json").write_text(json.dumps(
        {"normal": [0, 1, 0], "d": float("nan"), "origin": [0, 0, 0]}))
    with pytest.raises(AssertionError, match="not finite"):
        chip_smoke.check_ground(tmp_path / "ground.json", "t")
