"""``depth-pro-maps-torch``: batch depth maps for video frames with the PyTorch port.

Same behaviour as the JAX package's ``depth-pro-maps``
(``ml_depth_pro_video_tpu/cli/generate_depth_maps.py``): a single image or a
frame directory through one resident model (``DepthVideoRunner``), written as
colormapped or 16-bit grayscale PNGs with optional metric ``.npz``; or, with
``--video_out``, a video file or frame directory straight into a colormapped
depth video with a stable color range, optional temporal smoothing and
[RGB | depth] frames. ``--packed_fetch`` fetches depth as log-u16 codes
(``video/pack.py``). ``--device`` picks the card (default ``cuda``), and
``--exported`` serves the forwards of the maps from a
``depth-pro-export-torch`` artifact (the runner's ``exported_path``).
``--model vda_large`` (or ``vda_tiny``) runs Video Depth Anything
(``models/video_depth_anything.py``) instead: the frames in order through
32-frame windows, stitched into one consistent stream, each map the frame's
relative inverse depth (near is bright; the ``.npz`` holds
``inverse_depth``), on one process.

Across ranks (one process per card, ``parallel/multihost.py``): run the same
command on every rank, under ``torchrun --nproc_per_node N`` or with
``--coordinator host:port --num_processes N --process_id r``. Every rank
takes rank 0's frame list, the frames split over the ranks in dp batches
(``DepthVideoRunner.depth_stream_multihost``) and each rank writes only its
own frames' files. PNG output needs Pillow, colormaps other than gray need
matplotlib, and video input and output need OpenCV (or imageio).
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from ..models.depth_pro import MODEL_PRESETS, SPEED_PRESETS, model_preset
from ..models.video_depth_anything import VDA_PRESETS, vda_preset
from ..parallel import multihost
from ..parallel.mesh import batch_sharding, make_mesh
from ..video.runner import DepthVideoRunner

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v"}


def colorize_depth(depth: np.ndarray, colormap: str = "turbo", invert: bool = False,
                   vmin: float | None = None, vmax: float | None = None) -> np.ndarray:
    """Depth map -> normalized color or grayscale image.

    Min-max normalization of metric depth (near = low value), robust to
    NaN and inf; ``invert=True`` flips it for an inverse-depth look.
    ``vmin``/``vmax`` pin the range (a video needs one range across frames:
    per-frame min-max flickers the colors even when the depth is steady)."""
    d = np.asarray(depth, dtype=np.float64)
    finite = np.isfinite(d)
    if not finite.any():
        d = np.zeros_like(d)
        lo, hi = 0.0, 1.0
    else:
        lo = d[finite].min() if vmin is None else float(vmin)
        hi = d[finite].max() if vmax is None else float(vmax)
        d = np.nan_to_num(d, nan=lo, posinf=hi, neginf=lo)
    normed = np.clip((d - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    if invert:
        normed = 1.0 - normed
    if colormap in ("gray16", "grayscale16"):
        return (normed * 65535).astype(np.uint16)
    if colormap in ("gray", "grayscale"):
        return (normed * 255).astype(np.uint8)
    import matplotlib

    cm = matplotlib.colormaps[colormap]
    return (cm(normed)[..., :3] * 255).astype(np.uint8)


def save_depth_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    # uint16 arrays map to 16-bit grayscale ("I;16") natively
    Image.fromarray(arr).save(path)


def _precision(half_precision: bool) -> str:
    return "bf16" if half_precision else "fp32"


def generate_depth_maps(
    input_path: str,
    output_dir: str,
    colormap: str = "turbo",
    downscale_factor: float = 1.0,
    half_precision: bool = True,
    batch_size: int = 1,
    save_npz: bool = False,
    pattern: str = "*.png",
    runner=None,
    speed: str = "exact",
    model: str = "large",
    exported_path: str | None = None,
    packed_fetch: bool = False,
    device="cuda",
) -> list[str]:
    """Run depth over a file or a directory; return the PNG paths written.

    Over several ranks (``multihost.initialize`` first) every rank runs the
    same call: the frames split over the ranks and each rank writes only its
    own frames' files."""
    pod = multihost.world_size() > 1
    if os.path.isdir(input_path):
        paths = sorted(glob.glob(os.path.join(input_path, pattern)))
    else:
        paths = [input_path]
    if pod:
        # every rank batches rank 0's list: a stale shared-filesystem glob on
        # one rank would desync the row split (and the empty-input error below
        # must fire on every rank or none)
        paths = multihost.broadcast_json(paths)
    if not paths:
        raise FileNotFoundError(f"no inputs under {input_path}")
    os.makedirs(output_dir, exist_ok=True)
    if pod and exported_path is not None:
        raise ValueError("--exported serves one process's program; a run over several ranks "
                         "runs eagerly")
    if pod and packed_fetch:
        raise ValueError("--packed_fetch is single-host only (ranks fetch only their own rows)")
    if model in VDA_PRESETS and (pod or exported_path is not None or packed_fetch
                                 or speed != "exact"):
        raise ValueError(f"--model {model} runs its windows on one process, eagerly, at its "
                         "exact path, without the packed fetch")
    if runner is None and model in VDA_PRESETS:
        runner = DepthVideoRunner(cfg=vda_preset(model), precision=_precision(half_precision),
                                  downscale_factor=downscale_factor, device=device)
    if runner is None:
        mesh = None
        if pod:
            # one dp mesh over every rank; the runner rounds batch_size to a dp multiple
            mesh = make_mesh()
            batch_size = max(batch_size, multihost.world_size())
        runner = DepthVideoRunner(cfg=model_preset(model), precision=_precision(half_precision),
                                  batch_size=batch_size, downscale_factor=downscale_factor,
                                  speed=speed, mesh=mesh, exported_path=exported_path,
                                  fetch_pack="u16" if packed_fetch else "none", device=device)
    stream = runner.depth_stream_multihost(paths) if pod else runner.depth_stream(paths)
    n_expect = len(paths)
    if pod:
        # this rank yields only its rows; the progress counts them
        n_expect = multihost.local_item_count(batch_sharding(runner.mesh), runner.batch_size,
                                              len(paths))
    written = []
    t0 = time.time()
    # one bad frame must not lose the rest of the batch
    for i, result in enumerate(stream):
        stem = os.path.splitext(os.path.basename(result["key"]))[0]
        try:
            out = os.path.join(output_dir, f"{stem}_depth.png")
            if "inverse_depth" in result:  # relative: no metric depth, no f_px
                save_depth_image(out, colorize_depth(result["inverse_depth"], colormap))
                arrays = {"inverse_depth": result["inverse_depth"]}
            else:
                save_depth_image(out, colorize_depth(result["depth"], colormap))
                arrays = {"depth": result["depth"], "focallength_px": result["focallength_px"]}
            written.append(out)
            if save_npz:
                np.savez_compressed(os.path.join(output_dir, f"{stem}_depth.npz"), **arrays)
            print(f"[{i+1}/{n_expect}] {stem} ({(time.time()-t0)/(i+1):.2f}s/frame avg)")
        except Exception as exc:  # noqa: BLE001 - reported, the stream goes on
            print(f"Error processing {stem}: {exc}")
    if pod:
        print(f"[rank {multihost.rank()}/{multihost.world_size()}] wrote {len(written)} of "
              f"this rank's rows ({len(paths)} frames total)")
    else:
        print(f"Successfully wrote {len(written)}/{len(paths)} depth maps")
    return written


class _RangeTracker:
    """EMA-stabilized (lo, hi) normalization range over a depth stream.

    Per-frame min-max makes the colormap breathe as the scene's depth
    extent changes. ``momentum`` blends each frame's range into a running
    one (0 = per frame); an explicit ``fixed`` range turns tracking off. The
    range moves toward the observed extremes at the smoothed rate, so one
    outlier frame cannot blow out the whole video's contrast."""

    def __init__(self, momentum: float = 0.9, fixed: tuple[float, float] | None = None):
        self.momentum = float(momentum)
        self.fixed = fixed
        self.lo = self.hi = None

    def update(self, depth: np.ndarray) -> tuple[float, float]:
        if self.fixed is not None:
            return self.fixed
        finite = np.isfinite(depth)
        if not finite.any():
            return (self.lo, self.hi) if self.lo is not None else (0.0, 1.0)
        lo, hi = float(depth[finite].min()), float(depth[finite].max())
        if self.lo is None:
            self.lo, self.hi = lo, hi
        else:
            m = self.momentum
            self.lo = m * self.lo + (1.0 - m) * lo
            self.hi = m * self.hi + (1.0 - m) * hi
        return self.lo, self.hi


def generate_depth_video(
    input_path: str,
    output_path: str,
    colormap: str = "turbo",
    downscale_factor: float = 1.0,
    half_precision: bool = True,
    batch_size: int = 1,
    speed: str = "exact",
    temporal_smooth: float = 0.0,
    side_by_side: bool = False,
    depth_range: tuple[float, float] | None = None,
    range_momentum: float = 0.9,
    fps: float | None = None,
    start: int = 0,
    end: int | None = None,
    stride: int = 1,
    pattern: str = "*.png",
    runner=None,
    model: str = "large",
    packed_fetch: bool = False,
    device="cuda",
) -> int:
    """Video file (or frame directory) -> colormapped depth video.

    Frames stream from the decoder through the resident batched model into
    a streaming encoder: no intermediate files, O(1) host memory. Colors use
    an EMA-stabilized range (``depth_range`` pins it); ``side_by_side``
    writes [RGB | depth]; ``temporal_smooth`` turns on the flicker filter
    (``video/temporal.py``). Returns the number of frames written."""
    from ..video.writer import VideoSink

    if model in VDA_PRESETS:
        raise ValueError(f"--model {model} writes maps (PNG and npz); --video_out runs Depth "
                         "Pro's presets")
    if colormap in ("gray16", "grayscale16"):
        raise ValueError("16-bit grayscale is for PNG output; video frames are 8-bit "
                         "(use --colormap gray)")
    if os.path.isdir(input_path):
        paths = sorted(glob.glob(os.path.join(input_path, pattern)))
        if not paths:
            raise FileNotFoundError(f"no {pattern} frames under {input_path}")
        # end is inclusive, as video_frames' frame index is
        items = paths[start:None if end is None else end + 1:stride]
        n_est, src_fps = len(items), 30.0
    else:
        from ..video.decode import video_frames, video_info

        info = video_info(input_path)
        src_fps = (info["fps"] or 30.0) / max(stride, 1)
        n_est = None  # CAP_PROP_FRAME_COUNT is an estimate
        items = (frame for _, frame in video_frames(input_path, start=start, end=end,
                                                    stride=stride))
    runner = runner or DepthVideoRunner(
        cfg=model_preset(model), precision=_precision(half_precision), batch_size=batch_size,
        downscale_factor=downscale_factor, speed=speed, temporal_smooth=temporal_smooth,
        fetch_pack="u16" if packed_fetch else "none", device=device)
    tracker = _RangeTracker(momentum=range_momentum, fixed=depth_range)
    t0 = time.time()
    with VideoSink(output_path, fps=fps or src_fps) as sink:
        for i, result in enumerate(runner.depth_stream(items)):
            lo, hi = tracker.update(result["depth"])
            frame = colorize_depth(result["depth"], colormap, vmin=lo, vmax=hi)
            if frame.ndim == 2:  # gray colormap -> 3 channels for video
                frame = np.repeat(frame[..., None], 3, axis=2)
            if side_by_side:
                frame = np.concatenate([result["image"], frame], axis=1)
            sink.append(frame)
            if (i + 1) % 25 == 0:
                tot = f"/{n_est}" if n_est else ""
                print(f"[{i+1}{tot}] {(time.time()-t0)/(i+1):.2f}s/frame avg")
    print(f"Wrote {sink.frames_written} depth frames -> {output_path}")
    return sink.frames_written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Batch depth maps (PyTorch port)")
    ap.add_argument("input", help="image file, frames directory, or (with --video_out) a "
                                  "video file")
    ap.add_argument("-o", "--output_dir", help="PNG output directory (required unless "
                                               "--video_out)")
    ap.add_argument("--video_out", default=None, metavar="OUT.mp4",
                    help="encode a colormapped depth video instead of PNGs (input may be a "
                         "video file or a frames directory)")
    ap.add_argument("--side_by_side", action="store_true",
                    help="with --video_out: write [RGB | depth] frames")
    ap.add_argument("--temporal_smooth", type=float, default=0.0,
                    help="with --video_out: EMA weight (0=off) for flicker-free depth "
                         "(video/temporal.py)")
    ap.add_argument("--depth_range", type=float, nargs=2, default=None,
                    metavar=("NEAR", "FAR"),
                    help="with --video_out: fix the colormap range in meters (default: an "
                         "EMA-stabilized range over the stream)")
    ap.add_argument("--fps", type=float, default=None,
                    help="with --video_out: output fps (default: source fps / stride, or 30 "
                         "for frame directories)")
    ap.add_argument("--start", type=int, default=0, help="first frame index (video/frames "
                                                         "input)")
    ap.add_argument("--end", type=int, default=None, help="last frame index, inclusive")
    ap.add_argument("--stride", type=int, default=1, help="keep every Nth frame")
    ap.add_argument("--colormap", default="turbo",
                    choices=["turbo", "viridis", "magma", "plasma", "inferno",
                             "gray", "grayscale", "gray16", "grayscale16"])
    ap.add_argument("--downscale_factor", type=float, default=1.0)
    ap.add_argument("--half_precision", action="store_true", default=True,
                    help="bf16 compute (the default)")
    ap.add_argument("--full_precision", dest="half_precision", action="store_false",
                    help="fp32 compute")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--speed", choices=sorted(SPEED_PRESETS), default="exact",
                    help="ToMe token-merge tiers (balanced=0.25, fast=0.5 merge ratio)")
    ap.add_argument("--save_npz", action="store_true")
    ap.add_argument("--pattern", default="*.png")
    ap.add_argument("--exported", default=None,
                    help="an artifact of depth-pro-export-torch (exported at --batch_size "
                         "and the model's resolution; other batches run eagerly); on the card it currently starts and runs slower than eager code (PERF.md, ROADMAP B8)")
    ap.add_argument("--packed_fetch", action="store_true",
                    help="fetch depth as device-quantized log-u16 (half the device->host "
                         "bytes; <=1.5e-4 relative error, video/pack.py)")
    ap.add_argument("--model", choices=list(MODEL_PRESETS) + list(VDA_PRESETS), default="large",
                    help="model family member (base/small need a trained checkpoint); "
                         "vda_large: Video Depth Anything, relative inverse depth in stitched "
                         "32-frame windows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    multihost.add_multihost_args(ap)
    args = ap.parse_args(argv)
    # before the model is built (nothing to join single-process); over
    # several ranks the frames split over them and each writes its own
    if multihost.initialize_from_args(args) and args.video_out:
        ap.error("--video_out needs every frame in playback order on one rank; run it on one "
                 "rank (or write PNGs over several and encode them afterwards)")
    is_video = os.path.splitext(args.input)[1].lower() in VIDEO_EXTS
    if args.video_out:
        generate_depth_video(
            args.input, args.video_out, colormap=args.colormap,
            downscale_factor=args.downscale_factor, half_precision=args.half_precision,
            batch_size=args.batch_size, speed=args.speed,
            temporal_smooth=args.temporal_smooth, side_by_side=args.side_by_side,
            depth_range=tuple(args.depth_range) if args.depth_range else None,
            fps=args.fps, start=args.start, end=args.end, stride=args.stride,
            pattern=args.pattern, model=args.model, packed_fetch=args.packed_fetch,
            device=args.device)
        return
    if is_video:
        ap.error(f"{args.input} is a video file: pass --video_out OUT.mp4, or extract its "
                 "frames to a directory first")
    if not args.output_dir:
        ap.error("-o/--output_dir is required (or use --video_out)")
    generate_depth_maps(args.input, args.output_dir, colormap=args.colormap, speed=args.speed,
                        downscale_factor=args.downscale_factor,
                        half_precision=args.half_precision, batch_size=args.batch_size,
                        save_npz=args.save_npz, pattern=args.pattern, model=args.model,
                        exported_path=args.exported, packed_fetch=args.packed_fetch,
                        device=args.device)


if __name__ == "__main__":  # pragma: no cover
    main()
