"""``depth-pro-video-torch``: video frames -> depth -> floor plans with the PyTorch port.

Same flags and behaviour as the JAX package's ``depth-pro-video``
(``ml_depth_pro_video_tpu/video/pipeline.py::main``), plus ``--device``
(default ``cuda``)::

  depth-pro-video-torch --frames_dir frames/ --output_dir plans/ --batch_size 2 \\
      --num_workers 4 --renderer fast

``--video clip.mp4`` decodes the video into ``--frames_dir`` first (OpenCV
and Pillow), skipping the decode when a complete frame set is already there.
``--geometry device`` renders each plain floor plan with the program of
``geom/device_floorplan.py`` on ``--device`` (it implies
``--no_fit_shapes``). Over several ranks (``torchrun --nproc_per_node N``,
or ``--coordinator``, ``--num_processes``, ``--process_id`` on every rank)
the frames split over the ranks and each writes its own frames' plans
(``video/pipeline.py``); rank 0 alone decodes ``--video`` while the others
wait. The default ``--renderer matplotlib`` and the full artifact set of
``--fit_shapes`` need matplotlib; shape fitting needs scikit-learn and scipy.
"""

from __future__ import annotations

import argparse
import glob
import os

from ..models.depth_pro import MODEL_PRESETS, SPEED_PRESETS
from ..parallel import multihost
from ..video.pipeline import process_images_to_floor_plans


def _decode_on_primary(args) -> None:
    """Rank 0 decodes ``args.video`` onto the shared filesystem while the other
    ranks wait; its success or failure is broadcast first, so a failure
    raises on every rank instead of stranding the others at the barrier."""
    from ..video.decode import extract_frames

    err = None
    if multihost.is_primary():
        print(f"Decoding {args.video} -> {args.frames_dir}")
        try:
            extract_frames(args.video, args.frames_dir)
        except Exception as exc:  # noqa: BLE001 - re-raised on every rank just below
            err = f"{type(exc).__name__}: {exc}"
    else:
        print(f"waiting for rank 0 to decode {args.video}...")
    err = multihost.broadcast_json(err)
    if err is not None:
        raise RuntimeError(f"rank 0's video decode failed (every rank stops): {err}")
    multihost.barrier("video-decode")


def _frames_complete(args) -> bool:
    """Whether ``args.frames_dir`` already holds the whole decode of
    ``args.video``: the decode-complete marker's count, or failing that the
    container's frame count (an estimate, said so)."""
    from ..video.decode import DECODE_COMPLETE_MARKER, video_info

    have = glob.glob(os.path.join(args.frames_dir, args.pattern))
    # --resume reruns must not re-decode the whole video before the progress
    # filter even looks at what is done, but an interrupted decode leaves a
    # silently truncated frame set, so "frames exist" is not enough
    complete = False
    if have and not args.force_reprocess:
        marker = os.path.join(args.frames_dir, DECODE_COMPLETE_MARKER)
        if os.path.exists(marker):
            try:
                with open(marker) as f:
                    expected = int(f.read().strip())
            except (ValueError, OSError):
                expected = -1
            complete = 0 <= expected <= len(have)
        else:
            try:
                expected = video_info(args.video)["frames"]
            except Exception:
                expected = 0
            complete = expected > 0 and len(have) >= expected
            if complete:
                # CAP_PROP_FRAME_COUNT is container metadata, an estimate
                # (VFR/webm under-report), so this can accept a truncated
                # frame set that predates the marker: say so
                print(f"NOTE: {len(have)} frames >= the container's estimated count "
                      f"({expected}) but no decode-complete marker exists — completeness "
                      "is inferred from metadata; pass --force_reprocess if frames look "
                      "truncated")
        if not complete:
            print(f"{len(have)} frames in {args.frames_dir} look incomplete (no "
                  "decode-complete marker / fewer than the video's frame count); "
                  "re-extracting")
    if complete:
        print(f"{len(have)} frames already extracted in {args.frames_dir}; skipping decode "
              "(--force_reprocess re-extracts)")
    return complete


def main(argv=None):
    ap = argparse.ArgumentParser(description="Video frames -> floor plans (PyTorch port)")
    ap.add_argument("--frames_dir", required=False, default=None,
                    help="directory of frames (or destination when --video is given)")
    ap.add_argument("--video", default=None,
                    help="decode this video file into frames_dir first")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--height_threshold", type=float, default=1.3)
    ap.add_argument("--point_size", type=float, default=10)
    ap.add_argument("--downscale_factor", type=float, default=1.0)
    ap.add_argument("--half_precision", action="store_true", default=True,
                    help="bf16 compute (the default, unlike the fp32 reference)")
    ap.add_argument("--full_precision", dest="half_precision", action="store_false")
    ap.add_argument("--start_frame", type=int, default=None)
    ap.add_argument("--end_frame", type=int, default=None)
    ap.add_argument("--pattern", default="output_*.png")
    # reference defaults: shape fitting and the full artifact set are ON;
    # --output_main_only suppresses the artifacts
    ap.add_argument("--fit_shapes", action="store_true", default=True)
    ap.add_argument("--no_fit_shapes", dest="fit_shapes", action="store_false")
    ap.add_argument("--visualize_3d", action="store_true")
    ap.add_argument("--num_workers", "--num_threads", type=int, default=2)
    ap.add_argument("--simple_output", action="store_true")
    ap.add_argument("--output_all_files", action="store_true", default=True)
    ap.add_argument("--output_main_only", dest="output_all_files", action="store_false")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--force_reprocess", action="store_true")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--renderer", choices=["matplotlib", "fast"], default="matplotlib")
    ap.add_argument("--geometry", choices=["host", "device"], default="host",
                    help="device: run unproject/normalize/clean/splat as "
                         "ONE device program per frame (plain floorplan "
                         "output only; implies --no_fit_shapes — "
                         "geom/device_floorplan.py)")
    ap.add_argument("--device_subsample", type=int, default=1,
                    help="pixel stride for --geometry device: 2 takes a quarter "
                         "of the points at the same raster size")
    ap.add_argument("--speed", choices=sorted(SPEED_PRESETS), default="exact",
                    help="ToMe token-merge approximation tiers (balanced=0.25, fast=0.5 "
                         "merge ratio)")
    ap.add_argument("--parallel", choices=["none", "dp", "latency"], default="none",
                    help="over several ranks the frames split over them (dp; latency becomes "
                         "dp there); one rank runs unsharded")
    ap.add_argument("--packed_fetch", action="store_true",
                    help="fetch depth as device-quantized log-u16 (half the device->host "
                         "bytes; <=1.5e-4 relative error, video/pack.py)")
    ap.add_argument("--temporal_smooth", type=float, default=0.0,
                    help="EMA weight (0=off) for flicker-free video depth: scale-aligned "
                         "blending on static pixels, motion passes through "
                         "(video/temporal.py)")
    ap.add_argument("--model", choices=list(MODEL_PRESETS), default="large",
                    help="model family member (base/small need a trained checkpoint)")
    ap.add_argument("--x_limits", type=float, nargs=2, default=None)
    ap.add_argument("--z_limits", type=float, nargs=2, default=None)
    # reference-style individual bound flags
    ap.add_argument("--x_min", type=float, default=None)
    ap.add_argument("--x_max", type=float, default=None)
    ap.add_argument("--z_min", type=float, default=None)
    ap.add_argument("--z_max", type=float, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    multihost.add_multihost_args(ap)
    args = ap.parse_args(argv)
    # before the model is built (nothing to join single-process)
    pod = multihost.initialize_from_args(args)
    if args.x_limits is None and args.x_min is not None and args.x_max is not None:
        args.x_limits = [args.x_min, args.x_max]
    if args.z_limits is None and args.z_min is not None and args.z_max is not None:
        args.z_limits = [args.z_min, args.z_max]
    if not args.frames_dir and not args.video:
        ap.error("--frames_dir or --video is required")
    if args.video:
        from ..video.decode import extract_frames

        args.frames_dir = args.frames_dir or os.path.splitext(args.video)[0] + "_frames"
        complete = _frames_complete(args)
        if pod:
            # every rank takes rank 0's answer (the barrier is collective)
            if not multihost.broadcast_from_primary(complete):
                _decode_on_primary(args)
        elif not complete:
            print(f"Decoding {args.video} -> {args.frames_dir}")
            extract_frames(args.video, args.frames_dir)
    process_images_to_floor_plans(
        frames_dir=args.frames_dir, output_dir=args.output_dir,
        height_threshold=args.height_threshold, point_size=args.point_size,
        downscale_factor=args.downscale_factor, half_precision=args.half_precision,
        start_frame=args.start_frame, end_frame=args.end_frame, pattern=args.pattern,
        # --geometry device implies --no_fit_shapes (the default
        # fit_shapes=True would otherwise always trip the guard)
        fit_shapes=args.fit_shapes and args.geometry != "device",
        visualize_3d=args.visualize_3d,
        num_workers=args.num_workers, simple_output=args.simple_output,
        output_all_files=args.output_all_files, resume=args.resume,
        force_reprocess=args.force_reprocess, batch_size=args.batch_size,
        renderer=args.renderer, parallel=args.parallel, speed=args.speed,
        temporal_smooth=args.temporal_smooth, model=args.model,
        packed_fetch=args.packed_fetch, geometry=args.geometry,
        device_subsample=args.device_subsample,
        x_limits=tuple(args.x_limits) if args.x_limits else None,
        z_limits=tuple(args.z_limits) if args.z_limits else None,
        device=args.device,
    )


if __name__ == "__main__":  # pragma: no cover
    main()
