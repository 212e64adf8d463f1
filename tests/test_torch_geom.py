"""The port's copy of the host geometry (``geom/*``, ``native/``) against the
JAX package's, on the CPU.

One seeded scene (a floor, a back wall and a box seen from 1.5 m, with 1%
depth noise and a few invalid pixels) goes through each function of both
packages, on the native C++ route and again with the native library switched
off in both (``_load`` returns None, so every caller takes its numpy path).
The code and the C++ sources are the same, so the results must be equal bit
for bit: no tolerance. A chained stage takes as input what the JAX package's
earlier stages made of the scene, the same arrays for both packages.
"""

import ctypes
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import ml_depth_pro_video_tpu.native as jnative
import ml_depth_pro_video_tpu_torch.native as tnative
from ml_depth_pro_video_tpu.geom import (
    clean as jclean,
    floorplan_viz as jviz,
    ground as jground,
    render as jrender,
    shapes as jshapes,
    unproject as junproject,
)
from ml_depth_pro_video_tpu.video import pipeline as jpipeline
from ml_depth_pro_video_tpu_torch.geom import (
    clean as tclean,
    floorplan_viz as tviz,
    ground as tground,
    render as trender,
    shapes as tshapes,
    unproject as tunproject,
)
from ml_depth_pro_video_tpu_torch.video import pipeline as tpipeline

JAX = SimpleNamespace(unproject=junproject, ground=jground, clean=jclean, shapes=jshapes,
                      viz=jviz, render=jrender, pipeline=jpipeline, native=jnative)
PORT = SimpleNamespace(unproject=tunproject, ground=tground, clean=tclean, shapes=tshapes,
                       viz=tviz, render=trender, pipeline=tpipeline, native=tnative)
H, W, F_PX, CAM_HEIGHT = 180, 240, 165.0, 1.5
SYMBOLS = ("radius_counts", "radius_mask", "clean_shadows_mask", "splat_floorplan",
           "voxel_downsample", "estimate_normals", "normalized_cloud", "unproject_valid",
           "bpa_reconstruct")


def room_scene(seed: int = 0):
    """(depth (H, W) float32 [m], image (H, W, 3) uint8): a floor 1.5 m below
    the camera, a wall at 5 m, a 0.8 m box face at 3 m; 1% noise, some NaN
    and zero pixels."""
    rng = np.random.default_rng(seed)
    xd = (np.arange(W) - W / 2.0)[None, :] / F_PX * np.ones((H, 1))
    yd = (np.arange(H) - H / 2.0)[:, None] / F_PX * np.ones((1, W))  # image y, down
    depth = np.full((H, W), 5.0)
    floor = yd > 1e-3
    depth[floor] = np.minimum(depth[floor], CAM_HEIGHT / yd[floor])
    box = (xd * 3.0 > 0.2) & (xd * 3.0 < 1.0) & (yd * 3.0 > CAM_HEIGHT - 0.8) & \
        (yd * 3.0 < CAM_HEIGHT)
    depth[box] = np.minimum(depth[box], 3.0)
    depth *= 1.0 + 0.01 * rng.standard_normal(depth.shape)
    depth = depth.astype(np.float32)
    depth.flat[rng.choice(depth.size, 40, replace=False)] = np.nan
    depth.flat[rng.choice(depth.size, 40, replace=False)] = 0.0
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return depth, image


@pytest.fixture(scope="module")
def scene():
    """The scene and what the JAX package's stages make of it (the inputs of
    the chained cases)."""
    depth, image = room_scene()
    points, _ = junproject.depth_to_3d(depth, F_PX)
    ground = jpipeline.compute_ground_from_frame(depth, F_PX)
    cloud = jpipeline.normalized_cloud_from_depth(depth, F_PX, image, ground)
    clean = jclean.clean_shadows(jclean.remove_stray_points(cloud, nb_points=20, radius=0.1))
    above = clean.points[clean.points[:, 1] > 0.1]
    return SimpleNamespace(depth=depth, image=image, points=points, ground=ground,
                           cloud=cloud, clean=clean, plan_2d=above[:, [0, 2]])


def _ground_fit(p, s):
    sample = s.points[np.random.default_rng(0).choice(len(s.points), 4000, replace=False)]
    return p.ground.fit_ground_plane(sample, seed=3)


def _ground_optimize(p, s):
    sample = s.points[::5]
    return p.ground.optimize_ground_plane(sample, jground.fit_ground_plane(sample, seed=0))


CASES = {
    "depth_to_3d": lambda p, s: p.unproject.depth_to_3d(s.depth, F_PX),
    "depth_to_3d_image": lambda p, s: p.unproject.depth_to_3d(s.depth, F_PX, image=s.image,
                                                              max_depth=4.5),
    "fit_ground_plane": _ground_fit,
    "optimize_ground_plane": _ground_optimize,
    "normalize_to_ground": lambda p, s: p.ground.normalize_to_ground(s.points, s.ground),
    "grid_ground_adjustment": lambda p, s: p.ground.grid_ground_adjustment(
        jground.normalize_to_ground(s.points, s.ground)),
    "remove_stray_points": lambda p, s: p.clean.remove_stray_points(s.cloud, nb_points=20,
                                                                    radius=0.1),
    "clean_shadows": lambda p, s: p.clean.clean_shadows(s.cloud),
    "fit_shapes_to_clusters": lambda p, s: p.shapes.fit_shapes_to_clusters(s.plan_2d),
    "fast_floorplan_image": lambda p, s: p.viz.fast_floorplan_image(s.clean, height_threshold=1.3,
                                                                    width=256),
    "render_pointcloud_image": lambda p, s: p.render.render_pointcloud_image(
        s.clean, view="front", width=320, height=180),
    "normalized_cloud_from_depth": lambda p, s: p.pipeline.normalized_cloud_from_depth(
        s.depth, F_PX, s.image, s.ground),
    "compute_ground_from_frame": lambda p, s: p.pipeline.compute_ground_from_frame(s.depth,
                                                                                   F_PX),
}


def assert_same(got, want, where="result"):
    """Equal bit for bit, through dicts, sequences and point clouds (NaN
    equals NaN); same dtypes for arrays."""
    if hasattr(want, "points"):
        assert type(got).__name__ == type(want).__name__, where
        assert_same(got.points, want.points, f"{where}.points")
        assert_same(got.colors, want.colors, f"{where}.colors")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, g.dtype, w.dtype, g.shape,
                                                            w.shape)
        np.testing.assert_array_equal(g, w, err_msg=where)


def test_port_native_library_builds_from_its_own_sources():
    """The port's ``geom-native.so`` builds from the port's own five sources
    into the port's ``native/`` (written under a temporary name, then moved
    into place), and exports every symbol the bindings declare. First in the
    file: the cases below then load this build instead of making their own."""
    port_dir = Path(tnative.__file__).resolve().parent
    assert Path(tnative._SO).parent == port_dir
    assert [Path(s).parent for s in tnative._SOURCES] == [port_dir] * 5
    assert all(Path(s).is_file() for s in tnative._SOURCES)
    assert tnative._build()
    assert not Path(f"{tnative._SO}.{os.getpid()}.tmp").exists()
    lib = ctypes.CDLL(tnative._SO)
    for name in SYMBOLS:
        assert hasattr(lib, name), name
    assert tnative._load() is not None


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_geometry_equals_jax(scene, case, route, monkeypatch):
    if route == "numpy":
        for native in (jnative, tnative):
            monkeypatch.setattr(native, "_load", lambda: None)
    for native in (jnative, tnative):
        assert native.neighbors.available() == (route == "native")
    want = CASES[case](JAX, scene)
    got = CASES[case](PORT, scene)
    assert_same(got, want, case)


def test_scene_is_not_degenerate(scene):
    """The chained inputs exercise the stages: a ground plane near +Y at the
    camera's height, stray removal keeps most points, the shadow cleaning
    drops the wall's columns and keeps thousands, shapes are found."""
    normal = np.asarray(scene.ground["normal"])
    assert normal[1] > 0.99 and abs(scene.ground["d"] - CAM_HEIGHT) < 0.2
    kept = jclean.remove_stray_points(scene.cloud, nb_points=20, radius=0.1)
    assert 0.5 * len(scene.cloud) < len(kept) < len(scene.cloud)
    assert 2000 < len(scene.clean) < len(kept)
    rects, circles = jshapes.fit_shapes_to_clusters(scene.plan_2d)
    assert len(rects) + len(circles) > 0
