"""ctypes bindings for the native C++ geometry kernels.

Builds lazily with g++ on first use (cached as ``geom-native.so`` beside
the sources); every caller has a pure numpy/scipy fallback, so a missing
toolchain degrades performance, not capability.

Copy of ``ml_depth_pro_video_tpu/native/__init__.py`` and its five C++
sources (host code: the port imports nothing of the JAX package), except
that the library is written under a name of its own process and moved
into place with ``os.replace``: the lock below covers the threads of one
process only, and two processes (test workers, two pipelines) may build
at once.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

LOGGER = logging.getLogger(__name__)
_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, "neighbors.cpp"), os.path.join(_DIR, "geometry.cpp"),
            os.path.join(_DIR, "bpa.cpp"), os.path.join(_DIR, "shadows.cpp"),
            os.path.join(_DIR, "splat.cpp")]
# dash keeps pkgutil/import machinery from treating the ctypes
# library as a Python extension module
_SO = os.path.join(_DIR, "geom-native.so")

_lib = None
_tried = False


def _build() -> bool:
    # another process may be loading or building the same path: write a
    # name of this process's own, then swap it in atomically
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", *_SOURCES, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, _SO)
        return True
    except Exception as exc:  # pragma: no cover
        LOGGER.warning("native build failed (%s); using numpy fallback", exc)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_load_lock = threading.Lock()


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _load_lock:  # one build per process: concurrent first callers
        # (pipeline worker threads) must not start two g++ runs
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            stale = not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
                os.path.getmtime(s) for s in _SOURCES)
        except OSError:  # sources absent (prebuilt .so only): use it as-is
            stale = not os.path.exists(_SO)
        if stale and not _build():
            return None
        return _load_locked()


def _load_locked():
    global _lib
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as exc:  # pragma: no cover
        LOGGER.warning("native load failed: %s", exc)
        return None
    lib.radius_counts.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.radius_mask.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
    ]
    try:
        # round-5 symbol: a PREBUILT pre-round-5 .so without sources
        # (the supported sources-absent deployment path) must keep
        # serving its older kernels, not crash the whole module —
        # callers of this one fall back to numpy via the None return
        lib.clean_shadows_mask.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
    except AttributeError:  # pragma: no cover - stale prebuilt .so
        LOGGER.warning("geom-native.so predates clean_shadows_mask; "
                       "shadow cleanup uses the numpy path")
    try:
        lib.splat_floorplan.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
    except AttributeError:  # pragma: no cover - stale prebuilt .so
        LOGGER.warning("geom-native.so predates splat_floorplan; the "
                       "floorplan raster uses the numpy path")
    lib.voxel_downsample.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.voxel_downsample.restype = ctypes.c_int64
    lib.estimate_normals.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.normalized_cloud.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.normalized_cloud.restype = ctypes.c_int64
    lib.unproject_valid.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.unproject_valid.restype = ctypes.c_int64
    lib.bpa_reconstruct.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.bpa_reconstruct.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _rgb_image(image, hw) -> np.ndarray | None:
    """Contiguous (H, W, 3) uint8 view for the C++ kernels, or None when
    the image can't be made to match the depth map's (H, W) — the C++
    side indexes image[(r*w+c)*3+k] against the DEPTH dims, so a
    grayscale (H, W) array or a size mismatch would read out of bounds."""
    if image is None:
        return None
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] < 3 or img.shape[:2] != tuple(hw):
        return None
    return np.ascontiguousarray(img[..., :3], dtype=np.uint8)


class neighbors:
    """Namespace used by geom.clean / geom.mesh."""

    @staticmethod
    def available() -> bool:
        return _load() is not None

    @staticmethod
    def radius_counts(points: np.ndarray, radius: float) -> np.ndarray:
        lib = _load()
        pts = np.ascontiguousarray(points, dtype=np.float64)
        out = np.zeros(len(pts), dtype=np.int32)
        lib.radius_counts(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(pts), float(radius),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    @staticmethod
    def radius_mask(points: np.ndarray, radius: float, min_count: int) -> np.ndarray:
        """mask[i] = point i has >= min_count neighbors within radius
        (early-exit; much faster than exact counts on dense clouds)."""
        lib = _load()
        pts = np.ascontiguousarray(points, dtype=np.float64)
        out = np.zeros(len(pts), dtype=np.uint8)
        lib.radius_mask(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(pts), float(radius), int(min_count),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out.astype(bool)

    @staticmethod
    def splat_floorplan(points: np.ndarray, colors, height_threshold,
                        x_limits, z_limits, width: int, height: int,
                        point_radius: int, background) -> np.ndarray:
        """Tallest-wins floorplan raster (splat.cpp): returns the
        (height, width, 3) float32 image — identical pixels to the
        numpy splat+dilation in `geom/floorplan_viz.py`. None when the
        loaded .so predates the symbol (numpy fallback)."""
        lib = _load()
        if not hasattr(lib, "splat_floorplan"):  # stale prebuilt .so
            return None
        pts = np.ascontiguousarray(points, dtype=np.float64)
        col_ptr = None
        if colors is not None:
            cols = np.ascontiguousarray(colors, dtype=np.float64)
            col_ptr = cols.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        img = np.empty((height, width, 3), np.float32)
        img[:] = np.asarray(background, np.float32)
        lib.splat_floorplan(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            col_ptr, len(pts),
            float(height_threshold if height_threshold is not None else 0.0),
            1 if height_threshold is not None else 0,
            float(x_limits[0]), float(x_limits[1]),
            float(z_limits[0]), float(z_limits[1]),
            int(width), int(height), int(point_radius),
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return img

    @staticmethod
    def clean_shadows_mask(points: np.ndarray, shadow_height_threshold: float,
                           max_shadow_angle: float,
                           min_points_per_column: int) -> np.ndarray:
        """keep mask for `geom/clean.py::clean_shadows` (shadows.cpp):
        one threaded stable (cell, y) sort + the numpy path's exact
        algebraic pair-count rule — identical verdicts. Returns None
        when the loaded .so predates the symbol (numpy fallback)."""
        lib = _load()
        if not hasattr(lib, "clean_shadows_mask"):  # stale prebuilt .so
            return None
        pts = np.ascontiguousarray(points, dtype=np.float64)
        out = np.zeros(len(pts), dtype=np.uint8)
        lib.clean_shadows_mask(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(pts), float(shadow_height_threshold),
            float(max_shadow_angle), int(min_points_per_column),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out.astype(bool)

    @staticmethod
    def voxel_downsample(points: np.ndarray, colors: np.ndarray | None, voxel: float):
        lib = _load()
        pts = np.ascontiguousarray(points, dtype=np.float64)
        if len(pts) and float(np.abs(pts).max()) / max(float(voxel), 1e-300) >= 2**20:
            return None  # 21-bit grid keys would wrap: numpy fallback
        cols = None if colors is None else np.ascontiguousarray(colors, dtype=np.float64)
        out_p = np.zeros_like(pts)
        out_c = np.zeros_like(pts) if cols is not None else None
        m = lib.voxel_downsample(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if cols is not None else None,
            len(pts), float(voxel),
            out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if out_c is not None else None,
        )
        return out_p[:m], (out_c[:m] if out_c is not None else None)

    @staticmethod
    def estimate_normals(points: np.ndarray, radius: float, camera=(0.0, 0.0, 0.0)) -> np.ndarray:
        lib = _load()
        pts = np.ascontiguousarray(points, dtype=np.float64)
        out = np.zeros_like(pts)
        lib.estimate_normals(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(pts), float(radius),
            float(camera[0]), float(camera[1]), float(camera[2]),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out

    @staticmethod
    def normalized_cloud(depth: np.ndarray, f_px: float, ground_model: dict,
                         image: np.ndarray | None = None,
                         grid_size: int = 20, percentile: float = 5.0,
                         max_depth: float | None = None):
        """Fused depth -> normalized, grid-adjusted cloud (geometry.cpp).

        Mirrors depth_to_3d -> normalize_to_ground ->
        grid_ground_adjustment exactly; returns (points (N,3) float64,
        colors (N,3) float64 or None). None when the native lib is
        unavailable (callers fall back to the numpy chain).
        """
        lib = _load()
        if lib is None:
            return None
        # exact-mirror contract: the kernel computes in float32 depth, so
        # a float64 map (e.g. remove_depth_shadows output) must take the
        # numpy chain — matching depth_to_3d's own native-path gate
        if np.asarray(depth).dtype != np.float32:
            return None
        dep = np.ascontiguousarray(depth, dtype=np.float32)
        h, w = dep.shape
        normal = np.asarray(ground_model["normal"], dtype=np.float64)
        normal = normal / np.linalg.norm(normal)
        d = float(ground_model["d"])

        # rotation decided exactly as geom.ground.normalize_to_ground
        horizontal = np.array([0.0, 1.0, 0.0])
        if abs(normal @ horizontal) > 0.99:
            use_rot, R, y_shift = 0, np.eye(3), 0.0
        else:
            from ..geom.ground import rotation_between

            R = rotation_between(normal, horizontal)
            rn = R @ normal
            use_rot, y_shift = 1, float(-d / rn[1])
        R = np.ascontiguousarray(R, dtype=np.float64)

        img = _rgb_image(image, (h, w))
        if image is not None and img is None:
            return None  # unsupported image layout: numpy fallback handles it
        out_pts = np.empty((h * w, 3), dtype=np.float64)
        out_cols = np.empty((h * w, 3), dtype=np.float64) if img is not None else None
        n = lib.normalized_cloud(
            dep.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
            float(f_px), float(max_depth) if max_depth is not None else -1.0,
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if img is not None else None,
            normal.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), d,
            R.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), use_rot, y_shift,
            int(grid_size), float(percentile),
            out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            if out_cols is not None else None,
        )
        pts = out_pts[:n]
        return pts, (out_cols[:n] if out_cols is not None else None)

    @staticmethod
    def bpa_reconstruct(points: np.ndarray, normals: np.ndarray,
                        radii, max_tris: int | None = None):
        """Ball-pivoting reconstruction (native/bpa.cpp). Returns an
        (T, 3) int64 face array, or None if the native lib is missing."""
        lib = _load()
        if lib is None:
            return None
        pts = np.ascontiguousarray(points, dtype=np.float64)
        nrm = np.ascontiguousarray(normals, dtype=np.float64)
        if pts.shape != nrm.shape or pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(
                f"points {pts.shape} and normals {nrm.shape} must both be (N, 3)")
        if len(pts) >= 2**31:
            raise ValueError("BPA supports at most 2^31-1 points (int32 indices)")
        rad = np.ascontiguousarray(sorted(float(r) for r in radii), dtype=np.float64)
        cap = int(max_tris if max_tris is not None else max(4 * len(pts), 1024))
        out = np.empty((cap, 3), dtype=np.int64)
        nt = lib.bpa_reconstruct(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(pts),
            rad.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(rad),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        )
        return out[:nt].copy()

    @staticmethod
    def unproject_valid(depth: np.ndarray, f_px: float,
                        image: np.ndarray | None = None,
                        max_depth: float | None = None):
        """Raw unprojection + validity compaction (geometry.cpp).
        Returns (points (N,3) f64, valid (H,W) bool, colors or None),
        or None when the native lib is unavailable."""
        lib = _load()
        if lib is None:
            return None
        dep = np.ascontiguousarray(depth, dtype=np.float32)
        h, w = dep.shape
        img = _rgb_image(image, (h, w))
        if image is not None and img is None:
            return None  # unsupported image layout: numpy fallback handles it
        out_pts = np.empty((h * w, 3), dtype=np.float64)
        out_valid = np.empty((h, w), dtype=np.uint8)
        out_cols = np.empty((h * w, 3), dtype=np.float64) if img is not None else None
        n = lib.unproject_valid(
            dep.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
            float(f_px), float(max_depth) if max_depth is not None else -1.0,
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if img is not None else None,
            out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            if out_cols is not None else None,
        )
        return out_pts[:n], out_valid.astype(bool), (out_cols[:n] if out_cols is not None else None)
