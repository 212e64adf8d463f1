"""Depth-based 3D effects: parallax videos and red-cyan anaglyphs.

The port's own version of ``ml_depth_pro_video_tpu/effects/parallax.py``
(``depth-pro-effect-torch``): circle / zoom / swing camera motions with
depth-weighted displacement ``d * (1 - depth_norm)`` and anaglyph
synthesis from +-separation shifted views. Every frame is one bilinear
gather over the image on the device (``cuda`` unless the caller asks for
the CPU); a clip renders chunk by chunk and the host only encodes the
video.

Two reference bugs stay fixed, as in the JAX package:
`depth_video_effect.py:104,170-171` feed TRANSPOSED coordinate maps to
``cv2.remap`` (garbage for non-square frames), and `:107,180` write RGB
arrays through BGR writers, swapping the red and blue channels of every
output video and anaglyph.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.precision import resolve_device
from ..video.writer import VideoSink

MOTIONS = ("circle", "zoom", "swing")
CHUNK_BYTES = 256e6  # uint8 frames on the device per chunk


def bilinear_sample(image: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) image at fractional coords (cv2 INTER_LINEAR
    semantics with border clamp). Each corner is one gather by a flat
    linear index."""
    h, w = image.shape[:2]
    flat = image.reshape(-1, image.shape[-1])
    # NaN coordinates read pixel 0 instead of indexing out of range
    x = map_x.nan_to_num(nan=0.0).clamp(0.0, w - 1.0)
    y = map_y.nan_to_num(nan=0.0).clamp(0.0, h - 1.0)
    x0f, y0f = x.floor(), y.floor()
    x0, y0 = x0f.long(), y0f.long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    v00 = flat[y0 * w + x0]
    v01 = flat[y0 * w + x1]
    v10 = flat[y1 * w + x0]
    v11 = flat[y1 * w + x1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return ys, xs


def _parallax_chunk(image, depth_norm, amplitude, ts, motion_type: str) -> torch.Tensor:
    """Render the frames at phases ``ts`` on ``image``'s device: (T, H, W, 3)
    uint8, clipped and cast on the device (the fetch moves a quarter of the
    fp32 bytes)."""
    if motion_type not in MOTIONS:
        raise ValueError(f"Unknown motion type: {motion_type}")
    h, w = image.shape[:2]
    ys, xs = _grid(h, w, image.device)
    inv = 1.0 - depth_norm
    # a traced fp32 scalar in the JAX program, so amplitude * w rounds in fp32
    amp = torch.tensor(amplitude, dtype=torch.float32, device=image.device)
    out = torch.empty((ts.shape[0], h, w, 3), dtype=torch.uint8, device=image.device)
    for i in range(ts.shape[0]):
        t = ts[i]
        if motion_type == "circle":
            map_x = xs + amp * w * torch.cos(t) * inv
            map_y = ys + amp * h * torch.sin(t) * inv
        elif motion_type == "zoom":
            zoom = 1.0 + amp * torch.sin(t)
            map_x = xs + (1 - zoom) * (xs - w / 2)
            map_y = ys + (1 - zoom) * (ys - h / 2)
        else:  # swing
            map_x = xs + amp * w * torch.sin(t) * inv
            map_y = ys
        out[i] = bilinear_sample(image, map_x, map_y).clamp(0, 255).to(torch.uint8)
    return out


def parallax_frames(image: np.ndarray, depth: np.ndarray, duration: float = 5.0,
                    fps: int = 30, amplitude: float = 0.05,
                    motion_type: str = "circle", device="cuda") -> np.ndarray:
    """Render all parallax frames on ``device``; returns (T, H, W, 3) uint8.

    Frames render in fixed-size chunks of about 256 MB of device output
    (the last chunk is phase-padded to the same size), so a long 4K clip
    never needs tens of GB on the device. One chunk deep: chunk i+1 is
    dispatched before the host waits for chunk i's copy."""
    dev = resolve_device(device)
    img = torch.from_numpy(np.asarray(image, dtype=np.float32)).to(dev)
    d = np.asarray(depth, dtype=np.float32)
    depth_norm = torch.from_numpy((d - d.min()) / max(d.max() - d.min(), 1e-9)).to(dev)
    h, w = image.shape[:2]
    total = int(duration * fps)
    phases = 2.0 * np.pi * np.arange(total, dtype=np.float32) / max(total, 1)
    chunk = max(1, min(total, int(CHUNK_BYTES // (h * w * 3))))
    out = np.empty((total, h, w, 3), np.uint8)
    # two pinned host buffers on the card, taken in turn: chunk i's copy is
    # queued right behind its frames, so it lands while chunk i+1 renders
    pinned = dev.type == "cuda"
    host = [torch.empty((chunk, h, w, 3), dtype=torch.uint8, pin_memory=pinned)
            for _ in range(2 if pinned else 0)]
    pending = None

    def collect(j, m, frames, done):
        if done is not None:
            done.synchronize()
        out[j:j + m] = frames[:m].numpy()

    for n, i in enumerate(range(0, total, chunk)):
        sel = phases[i:i + chunk]
        ts = torch.from_numpy(np.pad(sel, (0, chunk - len(sel)))).to(dev)
        fr = _parallax_chunk(img, depth_norm, float(amplitude), ts, motion_type)
        done = None
        if pinned:
            fr = host[n % 2].copy_(fr, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        if pending is not None:
            collect(*pending)
        pending = (i, len(sel), fr, done)
    if pending is not None:
        collect(*pending)
    return out


def _anaglyph(image, depth_norm, dx):
    h, w = image.shape[:2]
    ys, xs = _grid(h, w, image.device)
    inv = 1.0 - depth_norm
    left = bilinear_sample(image, xs + dx * inv, ys)
    right = bilinear_sample(image, xs - dx * inv, ys)
    return torch.stack([left[..., 0], right[..., 1], right[..., 2]], dim=-1)


def anaglyph_image(image: np.ndarray, depth: np.ndarray, separation: float = 0.05,
                   device="cuda") -> np.ndarray:
    """Red-cyan anaglyph rendered on ``device``; returns (H, W, 3) uint8 RGB."""
    dev = resolve_device(device)
    img = torch.from_numpy(np.asarray(image, dtype=np.float32)).to(dev)
    d = np.asarray(depth, dtype=np.float32)
    depth_norm = torch.from_numpy((d - d.min()) / max(d.max() - d.min(), 1e-9)).to(dev)
    dx = torch.tensor(separation * image.shape[1], dtype=torch.float32, device=dev)
    out = _anaglyph(img, depth_norm, dx)
    return out.clamp(0, 255).to(torch.uint8).cpu().numpy()


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """Encode (T, H, W, 3) uint8 RGB frames to a video file on the host
    (``video/writer.VideoSink``: cv2 ``mp4v``, else imageio with a
    warning). Returns the encoder that wrote it, ``"cv2"`` or ``"imageio"``."""
    with VideoSink(path, fps=fps) as sink:
        for f in frames:
            sink.append(f)
        return sink.backend


def _runner(runner, device):
    from ..video.runner import DepthVideoRunner

    return runner or DepthVideoRunner(device=device)


def create_parallax_effect(image_path: str, output_path: str, duration: float = 5.0,
                           fps: int = 30, amplitude: float = 0.05,
                           motion_type: str = "circle", resolution_scale: float = 1.0,
                           runner=None, device="cuda") -> None:
    """End to end: image -> depth (the port's runner) -> parallax mp4; the
    frames render on the runner's device (``device`` builds the default
    runner and is ignored when ``runner`` is given)."""
    runner = _runner(runner, device)
    result = runner.infer_one(image_path)
    image, depth = result["image"], result["depth"]
    if resolution_scale != 1.0:
        from PIL import Image as PILImage

        h = int(image.shape[0] * resolution_scale)
        w = int(image.shape[1] * resolution_scale)
        image = np.asarray(PILImage.fromarray(image).resize((w, h)))
        depth = np.asarray(PILImage.fromarray(depth).resize((w, h), PILImage.BILINEAR))
    frames = parallax_frames(image, depth, duration, fps, amplitude, motion_type,
                             device=runner.device)
    write_video(output_path, frames, fps)


def create_3d_anaglyph(image_path: str, output_path: str, separation: float = 0.05,
                       runner=None, device="cuda") -> np.ndarray:
    """End to end: image -> depth -> anaglyph PNG, on the runner's device."""
    from PIL import Image as PILImage

    runner = _runner(runner, device)
    result = runner.infer_one(image_path)
    out = anaglyph_image(result["image"], result["depth"], separation, device=runner.device)
    PILImage.fromarray(out).save(output_path)
    return out


def main(argv=None):
    import argparse

    from ..models.depth_pro import MODEL_PRESETS, model_preset
    from ..video.runner import DepthVideoRunner

    ap = argparse.ArgumentParser(description="3D effects from depth (PyTorch port)")
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--effect", default="parallax", choices=["parallax", "anaglyph"])
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--amplitude", type=float, default=0.05)
    ap.add_argument("--motion", default="circle", choices=list(MOTIONS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--separation", type=float, default=0.05)
    ap.add_argument("--model", choices=list(MODEL_PRESETS), default="large",
                    help="model family member (base/small need a trained checkpoint)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    runner = DepthVideoRunner(cfg=model_preset(args.model), device=args.device)
    if args.effect == "parallax":
        create_parallax_effect(args.image_path, args.output_path, args.duration, args.fps,
                               args.amplitude, args.motion, args.scale, runner=runner)
    else:
        create_3d_anaglyph(args.image_path, args.output_path, args.separation, runner=runner)


if __name__ == "__main__":  # pragma: no cover
    main()
