"""Video batch orchestrator: frames -> depth -> clean point cloud -> floor plan.

The port's own version of ``ml_depth_pro_video_tpu/video/pipeline.py``,
on the port's ``DepthVideoRunner``, with the same behaviour on one host:
frame-range selection by the digits in the file name, the ground plane
computed once from the first frame (whose inference is reused) and cached
as ``ground.json``, per-frame success/timestamp resume through
``processing_progress.json`` (successes only, so a failed frame is
retried), ``--force_reprocess``, a graceful stop on SIGINT, ETA reporting
and fixed-axis framing. One resident model streams batched frames over
the card while the geometry of earlier frames runs on a thread pool
(clamped to the core count, with a bounded number of frames in flight):
the host chain (``geometry="host"``), or the floor-plan program of
``geom/device_floorplan.py`` on the runner's device (``geometry="device"``,
plain floor plans only, its framing cached as ``floorplan_limits.json``
beside the frames).

Across ranks (one process per card, ``parallel/multihost.py``) every rank
runs the same call: the frames split over the ranks in dp batches
(``DepthVideoRunner.depth_stream_multihost``), each rank runs the geometry
of its own frames and writes their files, the ground plane is fitted once on
rank 0 and broadcast, and each rank keeps its own
``processing_progress.p<rank>.json`` (rank 0 the plain name; resume reads
the union). ``parallel="latency"`` there becomes dp over the ranks, as the
JAX package's pod path does. A single process runs unsharded whatever
``parallel`` says: it drives one card (launch one rank per card to use
more).
"""

from __future__ import annotations

import glob
import json
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..geom.clean import clean_shadows, remove_stray_points
from ..geom.device_floorplan import DeviceFloorplanSession
from ..geom.floorplan_viz import (
    fast_floorplan_image,
    fast_floorplan_visualization,
    floorplan_visualization,
)
from ..geom.ground import (
    fit_ground_plane,
    grid_ground_adjustment,
    load_ground_plane,
    normalize_to_ground,
    optimize_ground_plane,
    save_ground_plane,
)
from ..geom.pointcloud import PointCloud
from ..geom.render import save_render
from ..geom.unproject import depth_to_3d
from ..models.depth_pro import model_preset
from ..parallel import multihost as mh
from ..parallel.mesh import batch_sharding, make_mesh
from .runner import DepthVideoRunner


def frame_number(path: str) -> int | None:
    """The digits of a file name as one number (frame_12.png -> 12), or None."""
    digits = "".join(ch for ch in os.path.basename(path) if ch.isdigit())
    return int(digits) if digits else None


def normalized_cloud_from_depth(
    depth: np.ndarray,
    f_px: float,
    image: np.ndarray,
    ground_model: dict,
    grid_size: int = 20,
    ground_percentile: float = 5.0,
    max_depth: float | None = None,
) -> PointCloud:
    """depth map + ground model -> ground-normalized, grid-adjusted cloud.

    Hot path of the video pipeline: prefers the fused native kernel
    (native/geometry.cpp, one pass; exact same math) and falls back to
    the numpy chain when the native lib or uint8 colors are unavailable.
    """
    if image is None or image.dtype == np.uint8:
        from ..native import neighbors as native

        fused = native.normalized_cloud(
            depth, f_px, ground_model, image=image,
            grid_size=grid_size, percentile=ground_percentile, max_depth=max_depth,
        )
        if fused is not None:
            pts, cols = fused
            return PointCloud(pts, cols)
    cloud = depth_to_3d(depth, f_px, image=image, max_depth=max_depth)
    pts = normalize_to_ground(cloud.points, ground_model)
    pts = grid_ground_adjustment(pts, grid_size=grid_size, percentile=ground_percentile)
    return PointCloud(pts, cloud.colors)


def compute_ground_from_frame(depth: np.ndarray, f_px: float,
                              optimize: bool = True, seed: int = 0) -> dict:
    """Once-per-video ground fit, mirroring the reference's three-stage
    chain: fit on a <=50k sample, L-BFGS-B optimize, then a guided refit
    over all points."""
    points, _ = depth_to_3d(depth, f_px)
    if len(points) > 50_000:
        sel = np.random.default_rng(seed).choice(len(points), 50_000, replace=False)
        sample = points[sel]
    else:
        sample = points
    model = fit_ground_plane(sample, seed=seed)
    if optimize:
        model = optimize_ground_plane(sample, model)
    return fit_ground_plane(points, initial_model=model, seed=seed)


def process_single_frame(
    result: dict,
    output_dir: str,
    ground_model: dict,
    height_threshold: float = 1.3,
    point_size: float = 10,
    fit_shapes: bool = True,
    visualize_3d: bool = False,
    simple_output: bool = False,
    output_all_files: bool = True,
    x_limits=None,
    z_limits=None,
    renderer: str = "matplotlib",
    dpi: int = 300,
    device_session=None,
) -> tuple[bool, float]:
    """Geometry + visualization for one frame (depth already computed).
    Returns (success, seconds); any error is printed and counts as a
    failed frame (per-frame fault isolation). ``dpi`` defaults to the
    reference's 300. ``device_session`` (a
    ``geom.device_floorplan.DeviceFloorplanSession``) replaces the whole
    host geometry chain with the device program: same fault isolation,
    same output path."""
    t0 = time.time()
    try:
        frame_name = os.path.splitext(os.path.basename(result["key"]))[0]
        if device_session is not None:
            plan_path = os.path.join(output_dir, f"{frame_name}_clean_simple_view.png")
            device_session.process(result["depth"], result["image"],
                                   result["focallength_px"], plan_path)
            return True, time.time() - t0
        cloud = normalized_cloud_from_depth(
            result["depth"], result["focallength_px"], result["image"], ground_model
        )
        cloud = remove_stray_points(cloud, nb_points=20, radius=0.1)
        cloud = clean_shadows(cloud)

        if visualize_3d:
            save_render(
                os.path.join(output_dir, f"{frame_name}_pcd_preview.png"),
                cloud, view="front", width=1280, height=720,
            )

        plan_path = os.path.join(output_dir, f"{frame_name}_clean_simple_view.png")
        if renderer == "fast":
            # the numpy rasterizer draws shape overlays itself; matplotlib
            # only produces the _shapes/_floor_plan artifacts when
            # output_all_files asks for them
            if fit_shapes and not simple_output:
                fast_floorplan_visualization(
                    cloud, plan_path, height_threshold=height_threshold,
                    fit_shapes=True, output_all_files=output_all_files,
                    x_limits=x_limits, z_limits=z_limits, dpi=dpi,
                )
            else:
                fast_floorplan_image(cloud, plan_path, height_threshold=height_threshold,
                                     x_limits=x_limits, z_limits=z_limits)
        else:
            floorplan_visualization(
                cloud,
                plan_path,
                height_threshold=height_threshold,
                point_size=point_size,
                dpi=dpi,
                fit_shapes=fit_shapes and not simple_output,
                output_all_files=output_all_files,
                x_limits=x_limits,
                z_limits=z_limits,
            )
        return True, time.time() - t0
    except Exception as exc:  # noqa: BLE001 - per-frame fault isolation
        import traceback

        print(f"Error processing {result.get('key')}: {exc}")
        traceback.print_exc()
        return False, time.time() - t0


def _pod_ground(runner: DepthVideoRunner, first_path: str, frames_dir: str,
                cached: dict | None) -> dict:
    """The ground plane on every rank: rank 0's cached ``ground.json`` decides
    for everyone; without one, frame 0 goes through the model on every rank
    (a collective), rank 0 fits and saves the plane, and its success or
    failure is broadcast before the values, so a failure raises on every
    rank instead of stranding the others in the broadcast."""
    if not mh.broadcast_from_primary(cached is not None):
        if mh.is_primary():
            print("Computing ground plane from first frame...")
        first = None
        for res in runner.depth_stream_multihost([first_path]):
            first = res  # only the rank holding row 0 (rank 0) yields
        err = None
        if mh.is_primary():
            try:
                if first is None:
                    raise RuntimeError("the ground frame did not land on rank 0")
                cached = compute_ground_from_frame(first["depth"], first["focallength_px"])
                save_ground_plane(cached, frames_dir)
            except Exception as exc:  # noqa: BLE001 - re-raised on every rank just below
                err = f"{type(exc).__name__}: {exc}"
        err = mh.broadcast_json(err)
        if err is not None:
            raise RuntimeError(f"rank 0's ground fit failed (every rank stops): {err}")
    vals = mh.broadcast_json({
        "normal": np.asarray(cached["normal"], np.float64),
        "d": float(cached["d"]),
        "origin": np.asarray(cached["origin"], np.float64),
    } if mh.is_primary() else None)
    return {"normal": np.asarray(vals["normal"], np.float64), "d": float(vals["d"]),
            "origin": np.asarray(vals["origin"], np.float64)}


def process_images_to_floor_plans(
    frames_dir: str,
    output_dir: str | None = None,
    height_threshold: float = 1.3,
    point_size: float = 10,
    downscale_factor: float = 1.0,
    half_precision: bool = True,
    start_frame: int | None = None,
    end_frame: int | None = None,
    pattern: str = "output_*.png",
    fit_shapes: bool = True,
    visualize_3d: bool = False,
    num_workers: int = 2,
    simple_output: bool = False,
    output_all_files: bool = True,
    resume: bool = False,
    force_reprocess: bool = False,
    x_limits=None,
    z_limits=None,
    batch_size: int = 1,
    renderer: str = "matplotlib",
    runner: DepthVideoRunner | None = None,
    parallel: str = "none",
    speed: str = "exact",
    temporal_smooth: float = 0.0,
    model: str = "large",
    packed_fetch: bool = False,
    geometry: str = "host",
    device_subsample: int = 1,
    device="cuda",
):
    """Process a frame directory into per-frame floor plans.

    Returns this rank's progress record: {frame file name: {"success":
    True, "timestamp": ...}} for every frame done so far. ``device`` is the
    runner's (``cuda`` by default; ignored when ``runner`` is given);
    ``geometry="device"`` runs its floor-plan program on the runner's
    device, ``device_subsample`` its pixel stride. Over several ranks
    (``multihost.initialize`` first) every rank runs the same call on a
    shared frames filesystem; SIGINT must reach every rank."""
    pod = mh.world_size() > 1
    if geometry not in ("host", "device"):
        raise ValueError(f"geometry must be 'host' or 'device', got {geometry!r}")
    if geometry == "device" and (fit_shapes or visualize_3d):
        # the device program covers the plain floor plan only; shape
        # fitting and 3D previews need the cleaned host cloud
        raise ValueError(
            "--geometry device serves the plain floorplan path; "
            "shape fitting / 3D previews need the host cloud "
            "(drop --fit_shapes/--visualize_3d or use --geometry host)")
    if geometry == "device" and pod and (x_limits is None or z_limits is None):
        raise ValueError(
            "multi-host --geometry device needs explicit --x_limits/--z_limits (each rank "
            "would otherwise frame its own first frame and the plans would not align)")
    output_dir = output_dir or frames_dir
    os.makedirs(output_dir, exist_ok=True)

    image_paths = sorted(glob.glob(os.path.join(frames_dir, pattern)))
    if start_frame is not None or end_frame is not None:
        image_paths = [
            p for p in image_paths
            if (n := frame_number(p)) is not None
            and (start_frame is None or n >= start_frame)
            and (end_frame is None or n <= end_frame)
        ]
    had_any = bool(image_paths)

    # resume bookkeeping (processing_progress.json schema parity); each rank
    # owns its own progress file (concurrent writes to one path would corrupt
    # it) and the skip-completed filter reads the union of every
    # processing_progress*.json, a JAX pod run's included
    suffix = f".p{mh.rank()}" if pod and mh.rank() else ""
    progress_file = os.path.join(output_dir, f"processing_progress{suffix}.json")
    completed: dict = {}
    if resume and not force_reprocess:
        all_done: dict = {}
        for pf in sorted(glob.glob(os.path.join(output_dir, "processing_progress*.json"))):
            try:
                with open(pf) as f:
                    data = json.load(f)
            except Exception:
                data = None
            if data is not None:
                all_done.update(data)
            if pf == progress_file:
                completed = data if data is not None else {}
        image_paths = [p for p in image_paths if os.path.basename(p) not in all_done]
    if pod:
        # the filtered list decides the row split, so every rank takes rank
        # 0's view (a stale shared-filesystem read on one rank would desync
        # the batches); frames_dir-relative, so that a --pattern with a
        # directory component rejoins to the file on every rank
        names = mh.broadcast_json([os.path.relpath(p, frames_dir) for p in image_paths])
        image_paths = [os.path.join(frames_dir, n) for n in names]
        had_any = bool(mh.broadcast_from_primary(had_any))
    if not image_paths:
        print("All frames already processed." if had_any else "No images to process")
        return completed

    mesh = None
    if pod and runner is None:
        # over several ranks the frames split over them, whatever --parallel says
        if parallel == "latency":
            print("multi-host run: --parallel latency is single-host only; using pod-wide dp")
        if temporal_smooth > 0.0:
            raise ValueError("temporal_smooth is single-host only (frames interleave across "
                             "ranks); run the depth-pro-smooth-torch post-pass "
                             "(video/temporal.py::smooth_depth_files)")
        if packed_fetch:
            raise ValueError("packed_fetch is single-host only (ranks fetch only their own "
                             "rows)")
        mesh = make_mesh(tp=1)
        batch_size = max(batch_size, mh.world_size())
    elif runner is None and parallel in ("dp", "latency"):
        print(f"--parallel {parallel}: single device, running unsharded (one rank drives one "
              "card: launch one per card, e.g. torchrun --nproc_per_node N, to use more)")
    runner = runner or DepthVideoRunner(
        cfg=model_preset(model),
        precision="bf16" if half_precision else "fp32",
        batch_size=batch_size,
        downscale_factor=downscale_factor,
        mesh=mesh,
        speed=speed,
        temporal_smooth=temporal_smooth,
        fetch_pack="u16" if packed_fetch else "none",
        device=device,
    )

    stop = {"flag": False}
    prev_handler = signal.signal(signal.SIGINT, lambda *_: stop.__setitem__("flag", True))
    try:
        # ground plane: load cached or compute once from the first frame
        first_result = None
        ground_model = load_ground_plane(frames_dir)
        if pod:
            ground_model = _pod_ground(runner, image_paths[0], frames_dir, ground_model)
        elif ground_model is None:
            print("Computing ground plane from first frame...")
            first_result = runner.infer_one(image_paths[0])
            ground_model = compute_ground_from_frame(
                first_result["depth"], first_result["focallength_px"])
            save_ground_plane(ground_model, frames_dir)

        def result_stream():
            if pod:
                # this rank's rows only (frame 0 is inferred again: not worth a
                # cross-rank shuffle of its result); the SIGINT flag goes into
                # the stream, which resolves it over every rank per batch, so
                # the loops below must not break on it per rank
                yield from runner.depth_stream_multihost(image_paths,
                                                         should_stop=lambda: stop["flag"])
                return
            # reuse the ground-fit inference for frame 0 instead of running
            # it through the model a second time
            rest = image_paths
            if first_result is not None:
                yield first_result
                rest = image_paths[1:]
            yield from runner.depth_stream(rest)

        progress_lock = threading.Lock()

        def save_progress(name: str, ok: bool):
            # called from geometry worker threads; serialize the JSON write.
            # Only SUCCESSFUL frames are recorded (reference schema) so
            # --resume retries failures instead of skipping them forever.
            if not ok:
                return
            with progress_lock:
                completed[name] = {"success": True, "timestamp": time.time()}
                tmp = progress_file + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(completed, f, indent=2)
                os.replace(tmp, progress_file)

        t_start = time.time()
        n_done = 0
        total = len(image_paths)
        if pod:
            # this rank handles only its own rows: the ETA counts them
            total = mh.local_item_count(batch_sharding(runner.mesh), runner.batch_size,
                                        len(image_paths))
        # a worker pool only helps with cores to spare (GIL and memory
        # contention on one core), so clamp to the core count before
        # sizing the in-flight bound below
        num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        # bound in-flight geometry: inference streams far faster than the
        # host stages, and each queued result holds the full frame + depth
        # (~20 MB at 1536^2): an unbounded backlog runs out of memory
        inflight = threading.Semaphore(num_workers * 2)

        device_session = None
        if geometry == "device":
            ignored = [f for f, on in (
                ("--renderer fast", renderer == "fast"),
                ("--point_size", point_size != 10),
                ("--simple_output", simple_output)) if on]
            if ignored:
                # the device raster draws with a fixed radius-1 splat;
                # silence about dropped flags would read as a bug
                print("--geometry device renders the fixed-style device "
                      f"raster; ignoring: {', '.join(ignored)}")
            device_session = DeviceFloorplanSession(
                ground_model, height_threshold=height_threshold,
                x_limits=x_limits, z_limits=z_limits,
                # the derived framing persists next to ground.json, so a
                # --resume run keeps frame 0's scale and offset instead of
                # re-deriving them from the first unprocessed frame
                limits_cache=os.path.join(frames_dir, "floorplan_limits.json"),
                subsample=device_subsample, device=runner.device)

        def handle(result):
            nonlocal n_done
            try:
                ok, dt = process_single_frame(
                    result, output_dir, ground_model,
                    height_threshold=height_threshold, point_size=point_size,
                    fit_shapes=fit_shapes, visualize_3d=visualize_3d,
                    simple_output=simple_output, output_all_files=output_all_files,
                    x_limits=x_limits, z_limits=z_limits, renderer=renderer,
                    device_session=device_session,
                )
            finally:
                inflight.release()
            with progress_lock:
                n_done += 1
                done = n_done
            save_progress(os.path.basename(result["key"]), ok)
            avg = (time.time() - t_start) / done
            eta = avg * (total - done)
            print(f"[{done}/{total}] {os.path.basename(result['key'])} "
                  f"ok={ok} {dt:.1f}s (avg {avg:.1f}s/frame, ETA {eta/60:.1f} min)")

        if num_workers > 1:
            # device inference streams ahead; geometry overlaps on host threads
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                futures = []
                for result in result_stream():
                    if stop["flag"] and not pod:
                        break
                    inflight.acquire()
                    futures.append(pool.submit(handle, result))
                if stop["flag"]:
                    # drop queued work; only already-running frames finish
                    n_cancelled = sum(1 for fut in futures if fut.cancel())
                    print(f"Interrupted — finishing in-flight frames "
                          f"({n_cancelled} queued frames cancelled)...")
                for fut in futures:
                    if not fut.cancelled():
                        fut.result()
        else:
            for result in result_stream():
                if stop["flag"] and not pod:
                    print("Interrupted.")
                    break
                inflight.acquire()
                handle(result)
        return completed
    finally:
        signal.signal(signal.SIGINT, prev_handler)
