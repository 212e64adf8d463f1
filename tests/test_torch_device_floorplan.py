"""The port's device floor plan (``geom/device_floorplan.py``) against the JAX
package's, on the CPU.

The scene is ``tests/test_device_floorplan.py``'s: a 160² blurred box scene
from the JAX package's ``make_scene_boxes`` with its ground plane from
``compute_ground_from_frame``. Both programs run fp32 in the same order of
operations, so they are held far tighter than the JAX test holds its program
against the float64 host chain (coordinates within 2e-5 m there):

- coordinates of valid points within ``COORD_ATOL``, the height buffer
  within ``HBUF_ATOL`` where finite (and finite at the same pixels);
- ``valid``, ``keep_stray`` and ``keep`` differ on at most ``MASK_SHARE`` of
  the points (a point on a cell or voxel border can cross it by an ulp);
- the raster differs by at most ``RASTER_ATOL`` on at most ``RASTER_SHARE``
  of its pixels (the colour splat lets any tied point win, in both packages).

Then the JAX test's gates against the host chain, applied to the port's
program and the port's host chain with the same thresholds; the session's
framing, its limits cache and its PNG against the JAX session's; and the
device the session runs on.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.ndimage import gaussian_filter

import ml_depth_pro_video_tpu.geom.device_floorplan as jfp
import ml_depth_pro_video_tpu_torch.geom.device_floorplan as tfp
from ml_depth_pro_video_tpu.geom.unproject import unproject_dense as j_unproject_dense
from ml_depth_pro_video_tpu.utils.synthetic import make_scene_boxes
from ml_depth_pro_video_tpu.video.pipeline import compute_ground_from_frame
from ml_depth_pro_video_tpu_torch.geom.clean import (
    clean_shadows,
    radius_neighbor_counts,
    remove_stray_points,
)
from ml_depth_pro_video_tpu_torch.geom.floorplan_viz import fast_floorplan_image
from ml_depth_pro_video_tpu_torch.geom.ground import grid_ground_adjustment, normalize_to_ground
from ml_depth_pro_video_tpu_torch.geom.pointcloud import PointCloud
from ml_depth_pro_video_tpu_torch.geom.unproject import depth_to_3d, unproject_dense

SIZE = 160
COORD_ATOL = 1e-6   # metres; fp32 against fp32 (the JAX test's bar against float64: 2e-5)
HBUF_ATOL = 1e-6
MASK_SHARE = 1e-3   # of points
RASTER_ATOL = 1e-6  # colour units in [0, 1]
RASTER_SHARE = 1e-3  # of pixels beyond RASTER_ATOL
PNG_SHARE = 1e-3    # of a session PNG's pixels that may differ (ties)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    img, depth = make_scene_boxes(rng, SIZE)
    # the blur reproduces monocular depth-edge smear (shadow streaks) so the
    # cleanup stages have real work
    depth = gaussian_filter(depth, sigma=1.5).astype(np.float32)
    f_px = SIZE * 0.9
    ground = compute_ground_from_frame(depth, f_px)
    cloud = depth_to_3d(depth, f_px, image=img)
    pts = grid_ground_adjustment(normalize_to_ground(cloud.points, ground))
    return {"img": img, "depth": depth, "f_px": f_px, "ground": ground, "cloud": cloud,
            "adjusted": PointCloud(pts, cloud.colors)}


def _limits(pts, height_threshold=0.1):
    m = pts[:, 1] >= height_threshold
    x, z = -pts[m, 0], pts[m, 2]
    return (float(x.min()), float(x.max())), (float(z.min()), float(z.max()))


def _cfg_kw(scene, **kw):
    xl, zl = _limits(scene["adjusted"].points)
    return dict(height=SIZE, width=SIZE, x_limits=xl, z_limits=zl, raster_width=192, **kw)


def _run_port(scene, **kw):
    cfg = tfp.DeviceFloorplanConfig(**_cfg_kw(scene, **kw))
    fn = tfp.make_device_floorplan(cfg, scene["ground"], debug=True, device="cpu")
    out = fn(scene["depth"], scene["img"], np.float32(scene["f_px"]))
    assert all(v.device.type == "cpu" for v in out.values())
    return cfg, {k: v.numpy() for k, v in out.items()}


def _run_jax(scene, **kw):
    cfg = jfp.DeviceFloorplanConfig(**_cfg_kw(scene, **kw))
    fn = jfp.make_device_floorplan(cfg, scene["ground"], debug=True)
    return {k: np.asarray(v) for k, v in fn(scene["depth"], scene["img"],
                                            np.float32(scene["f_px"])).items()}


def test_unproject_dense_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 9.0, (2, 12, 20)).astype(np.float32)
    f_px = np.asarray([17.0, 23.5], np.float32)
    want = np.asarray(j_unproject_dense(depth, f_px))
    got = unproject_dense(torch.from_numpy(depth), torch.from_numpy(f_px)).numpy()
    assert got.shape == (2, 12, 20, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # a scalar focal length on one map, and the device follows the depth
    out = unproject_dense(torch.from_numpy(depth[0]), 17.0)
    np.testing.assert_allclose(out.numpy(), got[0], rtol=1e-6, atol=0)
    assert out.device.type == "cpu"


@pytest.mark.parametrize("n", [1, 2, 9, 4096])
def test_segment_bounds_match_jax(n):
    """The segment bounds (a scatter and a gather here, prefix scans in the
    JAX program) on sorted cell ids with runs of every length, one segment,
    and the invalid points' sentinel at the end."""
    rng = np.random.default_rng(n)
    cells = np.sort(rng.integers(0, max(n // 3, 1), n)).astype(np.int64)
    cells[-(n // 4):] = tfp.SHADOW_SENTINEL if n > 3 else cells[-1]
    want = jfp._segment_bounds(jnp.asarray(cells.astype(np.int32)))
    got = tfp._segment_bounds(torch.from_numpy(cells))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("subsample", [1, 2])
def test_program_matches_jax(scene, subsample):
    cfg, got = _run_port(scene, subsample=subsample)
    want = _run_jax(scene, subsample=subsample)
    assert set(got) == set(want) == {"raster", "x", "y", "z", "valid", "keep_stray", "keep",
                                     "hbuf"}
    n = ((SIZE + subsample - 1) // subsample) ** 2
    assert got["x"].shape == (n,) and got["raster"].shape == (cfg.raster_height, 192, 3)
    valid = want["valid"]
    for k in ("valid", "keep_stray", "keep"):
        assert got[k].dtype == np.bool_
        assert np.mean(got[k] != want[k]) <= MASK_SHARE, k
    for k in "xyz":
        np.testing.assert_allclose(got[k][valid], want[k][valid], rtol=0, atol=COORD_ATOL)
    finite = np.isfinite(want["hbuf"])
    np.testing.assert_array_equal(np.isfinite(got["hbuf"]), finite)
    np.testing.assert_allclose(got["hbuf"][finite], want["hbuf"][finite], rtol=0,
                               atol=HBUF_ATOL)
    off = np.abs(got["raster"] - want["raster"]).max(-1) > RASTER_ATOL
    assert off.mean() <= RASTER_SHARE


# tests/test_device_floorplan.py's gates against the host chain, on the port's program
# and the port's host chain, thresholds as they are there


def test_normalized_coords_exact(scene):
    _, out = _run_port(scene)
    valid = out["valid"]
    assert valid.sum() == len(scene["cloud"].points)
    dev = np.stack([out["x"][valid], out["y"][valid], out["z"][valid]], -1)
    np.testing.assert_allclose(dev, scene["adjusted"].points, atol=2e-5)


def test_stray_filter_is_a_superset(scene):
    _, out = _run_port(scene)
    valid = out["valid"]
    host_keep = radius_neighbor_counts(scene["adjusted"].points, 0.1) + 1 >= 20
    dev_keep = out["keep_stray"][valid]
    assert not (host_keep & ~dev_keep).any()
    extra = (~host_keep & dev_keep).sum() / max(valid.sum(), 1)
    assert extra < 0.35, extra


def test_shadow_filter_matches_host_rule(scene):
    # nb_points=1 keeps every point through the stray stage on both sides
    _, out = _run_port(scene, stray_nb_points=1)
    valid = out["valid"]
    assert out["keep_stray"][valid].all()
    host_out = clean_shadows(scene["adjusted"])
    host_keep = np.zeros(len(scene["adjusted"]), bool)
    kept_set = {tuple(p) for p in np.round(host_out.points, 6)}
    for i, p in enumerate(np.round(scene["adjusted"].points, 6)):
        host_keep[i] = tuple(p) in kept_set
    mismatch = (host_keep != out["keep"][valid]).mean()
    assert mismatch < 0.02, mismatch


def test_raster_close_to_host_chain(scene):
    cfg, out = _run_port(scene)
    cleaned = clean_shadows(remove_stray_points(scene["adjusted"]))
    host = fast_floorplan_image(
        cleaned, None, height_threshold=cfg.height_threshold, x_limits=cfg.x_limits,
        z_limits=cfg.z_limits, width=cfg.raster_width).astype(np.float32) / 255.0
    dev = out["raster"]
    assert host.shape == dev.shape
    bg_h = np.abs(host - 0.94).max(-1) < 0.02
    bg_d = np.abs(dev - 0.94).max(-1) < 0.02
    assert (~bg_h & bg_d).mean() < 0.02
    assert (bg_h != bg_d).mean() < 0.15
    color_err = np.abs(host - dev).max(-1)[~bg_h & ~bg_d]
    assert np.percentile(color_err, 95) < 0.02


def test_subsample_tier(scene):
    """Stride-2 coordinates are a subset of stride-1's, and the rasters agree
    structurally (the JAX test's bound)."""
    outs = {s: _run_port(scene, subsample=s)[1] for s in (1, 2)}
    side = int(np.sqrt(outs[1]["x"].shape[0]))
    np.testing.assert_allclose(outs[2]["x"], outs[1]["x"].reshape(side, side)[::2, ::2].ravel(),
                               atol=1e-6)
    bg1 = np.abs(outs[1]["raster"] - 0.94).max(-1) < 0.02
    bg2 = np.abs(outs[2]["raster"] - 0.94).max(-1) < 0.02
    assert (bg1 == bg2).mean() > 0.80


# the session


def _sessions(scene, tmp_path, **kw):
    return (jfp.DeviceFloorplanSession(scene["ground"], height_threshold=0.1,
                                       limits_cache=str(tmp_path / "jax_limits.json"), **kw),
            tfp.DeviceFloorplanSession(scene["ground"], height_threshold=0.1,
                                       limits_cache=str(tmp_path / "port_limits.json"),
                                       device="cpu", **kw))


@pytest.mark.parametrize("subsample", [1, 2])
def test_session_matches_jax(scene, tmp_path, subsample):
    """Derived framing, limits file and PNG against the JAX session's."""
    jsess, tsess = _sessions(scene, tmp_path, subsample=subsample, raster_width=256)
    for name, sess in (("jax", jsess), ("port", tsess)):
        sess.process(scene["depth"], scene["img"], scene["f_px"], str(tmp_path / f"{name}.png"))
    assert tsess.x_limits == jsess.x_limits and tsess.z_limits == jsess.z_limits
    assert (json.load(open(tmp_path / "port_limits.json"))
            == json.load(open(tmp_path / "jax_limits.json")))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert got.shape[1] == 256
    assert np.mean(np.any(got != want, axis=-1)) <= PNG_SHARE


def test_session_reuses_cached_limits(scene, tmp_path, monkeypatch):
    first = tfp.DeviceFloorplanSession(scene["ground"], limits_cache=str(tmp_path / "l.json"),
                                       device="cpu")
    first.process(scene["depth"], scene["img"], scene["f_px"], str(tmp_path / "a.png"))
    cached = json.load(open(tmp_path / "l.json"))
    assert cached["fingerprint"] == first._fingerprint()
    assert tuple(cached["x_limits"]) == first.x_limits

    def no_derivation(*_):
        raise AssertionError("the cached framing should have been reused")

    second = tfp.DeviceFloorplanSession(scene["ground"], limits_cache=str(tmp_path / "l.json"),
                                        device="cpu")
    monkeypatch.setattr(second, "_derive_limits", no_derivation)
    second.process(scene["depth"], scene["img"], scene["f_px"], str(tmp_path / "b.png"))
    assert second.x_limits == first.x_limits and second.z_limits == first.z_limits
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "b.png")),
                                  np.asarray(Image.open(tmp_path / "a.png")))


def test_session_rederives_on_a_fingerprint_mismatch(scene, tmp_path):
    path = tmp_path / "l.json"
    path.write_text(json.dumps({"x_limits": [0.0, 1.0], "z_limits": [0.0, 1.0],
                                "fingerprint": "another ground fit"}))
    sess = tfp.DeviceFloorplanSession(scene["ground"], limits_cache=str(path), device="cpu")
    sess.process(scene["depth"], scene["img"], scene["f_px"], str(tmp_path / "a.png"))
    assert sess.x_limits != (0.0, 1.0)
    rewritten = json.load(open(path))
    assert rewritten["fingerprint"] == sess._fingerprint()
    assert tuple(rewritten["x_limits"]) == sess.x_limits
    # a file from before the fingerprint existed is accepted as it is
    path.write_text(json.dumps({"x_limits": [-2.0, 2.0], "z_limits": [1.0, 6.0]}))
    old = tfp.DeviceFloorplanSession(scene["ground"], limits_cache=str(path), device="cpu")
    old.process(scene["depth"], scene["img"], scene["f_px"], str(tmp_path / "b.png"))
    assert old.x_limits == (-2.0, 2.0) and old.z_limits == (1.0, 6.0)


def test_session_on_a_degenerate_frame(scene, tmp_path):
    """Degenerate framings, as the JAX session handles them: nothing above
    the height threshold frames every point, and a far wall (depth 1e4 m,
    what an untrained model clamps to) coarsens the stray voxel grid to its
    budget. With no valid depth at all the host chain has nothing to frame
    (the JAX session fails the same way), so explicit limits are given and
    the raster is all background."""
    cases = {"nothing_above": (scene["depth"], {"height_threshold": 100.0}),
             "far_wall": (np.full((SIZE, SIZE), 1e4, np.float32), {})}
    for name, (depth, kw) in cases.items():
        jsess = jfp.DeviceFloorplanSession(scene["ground"], **kw)
        tsess = tfp.DeviceFloorplanSession(scene["ground"], device="cpu", **kw)
        for tag, sess in (("jax", jsess), ("port", tsess)):
            sess.process(depth, scene["img"], scene["f_px"], str(tmp_path / f"{name}_{tag}.png"))
        assert tsess.x_limits == jsess.x_limits and tsess.z_limits == jsess.z_limits
        got = np.asarray(Image.open(tmp_path / f"{name}_port.png"))
        want = np.asarray(Image.open(tmp_path / f"{name}_jax.png"))
        assert got.shape == want.shape
        assert np.mean(np.any(got != want, axis=-1)) <= PNG_SHARE
    assert tsess.cfg.stray_cell_scale > 0.5  # the far wall's grid was coarsened
    sess = tfp.DeviceFloorplanSession(scene["ground"], x_limits=(-2, 2), z_limits=(0, 4),
                                      raster_width=64, device="cpu")
    sess.process(np.zeros((SIZE, SIZE), np.float32), scene["img"], scene["f_px"],
                 str(tmp_path / "empty.png"))
    empty = np.asarray(Image.open(tmp_path / "empty.png"))
    assert empty.shape == (64, 64, 3) and (empty == 239).all()  # 0.94 * 255, truncated


def test_session_runs_on_the_device_it_was_given(scene, tmp_path, monkeypatch):
    built, ran = [], []
    real_make = tfp.make_device_floorplan

    def recording(*args, **kwargs):
        built.append(kwargs["device"])
        fn = real_make(*args, **kwargs)

        def wrapped(*inputs):
            out = fn(*inputs)
            ran.extend(v.device for v in out.values())
            return out
        return wrapped

    monkeypatch.setattr(tfp, "make_device_floorplan", recording)
    sess = tfp.DeviceFloorplanSession(scene["ground"], device="cpu")
    sess.process(scene["depth"], scene["img"], scene["f_px"], str(tmp_path / "a.png"))
    assert sess.device == torch.device("cpu") and built == [torch.device("cpu")]
    assert ran and {d.type for d in ran} == {"cpu"}
    # no card: asking for one raises instead of running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfp.DeviceFloorplanSession(scene["ground"])
    cfg = tfp.DeviceFloorplanConfig(**_cfg_kw(scene))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        real_make(cfg, scene["ground"])
