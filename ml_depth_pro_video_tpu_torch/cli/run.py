"""``depth-pro-run-torch``: single-image / directory depth inference with
the PyTorch port.

Same behaviour as the JAX package's ``depth-pro-run``
(``ml_depth_pro_video_tpu/cli/run.py``): per-image loop over a file or a
directory, EXIF focal length when available, ``.npz`` metric depth (key
``depth``) and a turbo JPEG of inverse depth with the reference's
[1/250, 1/0.1] display clamps, outputs mirroring the input's
subdirectories. ``--device`` picks the card (default ``cuda``);
``--exported`` serves the forwards from a ``depth-pro-export-torch``
artifact; decoding images needs Pillow.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

LOGGER = logging.getLogger(__name__)
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".heic", ".webp"}


def colorize(values: np.ndarray, cmap: str = "turbo") -> np.ndarray:
    """Normalized values -> uint8 RGB via a matplotlib colormap."""
    import matplotlib

    cm = matplotlib.colormaps[cmap]
    return (cm(values)[..., :3] * 255).astype(np.uint8)


def run(args) -> None:
    from PIL import Image

    from ..models.depth_pro import model_preset
    from ..video.runner import DepthVideoRunner

    if args.verbose:
        logging.basicConfig(level=logging.INFO)

    image_path = Path(args.image_path)
    if image_path.is_dir():
        paths = sorted(p for p in image_path.rglob("*") if p.suffix.lower() in IMAGE_EXTS)
    else:
        paths = [image_path]
    if not paths:
        raise SystemExit(f"No images found at {image_path}")

    runner = DepthVideoRunner(cfg=model_preset(args.model),
                              precision="bf16" if args.half else "fp32",
                              batch_size=args.batch_size, speed=args.speed,
                              exported_path=args.exported, device=args.device)

    fig = ax_rgb = ax_disp = None
    if not args.skip_display:
        try:
            import matplotlib.pyplot as plt

            plt.ion()
            fig, (ax_rgb, ax_disp) = plt.subplots(1, 2)
            fig.canvas.manager.set_window_title("Depth Pro")
        except Exception as exc:  # noqa: BLE001 - headless hosts
            LOGGER.warning("no interactive display (%s); continuing headless", exc)
            args.skip_display = True

    rel_root = image_path if image_path.is_dir() else image_path.parent
    for result in runner.depth_stream(str(p) for p in paths):
        src = Path(result["key"])
        depth = result["depth"]
        inv = 1.0 / np.clip(depth, 1e-9, None)
        hi = min(float(inv.max()), 1 / 0.1)
        lo = max(1 / 250, float(inv.min()))
        normed = np.clip((inv - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
        LOGGER.info("%s: f_px=%.1f", src.name, result["focallength_px"])
        if not args.skip_display:
            ax_rgb.imshow(result["image"])
            ax_disp.imshow(normed, cmap="turbo")
            fig.canvas.draw()
            fig.canvas.flush_events()
        if args.output_path is not None:
            base = Path(args.output_path) / src.relative_to(rel_root).parent / src.stem
            base.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(str(base) + ".npz", depth=depth)
            Image.fromarray(colorize(normed)).save(str(base) + ".jpg", quality=90)
            print(f"wrote {base}.npz / .jpg")
        else:
            print(f"{src.name}: depth [{depth.min():.2f}, {depth.max():.2f}] m, "
                  f"f_px={result['focallength_px']:.1f}")

    if not args.skip_display:
        import matplotlib.pyplot as plt

        plt.show(block=True)


def main(argv=None) -> None:
    from ..models.depth_pro import MODEL_PRESETS, SPEED_PRESETS

    ap = argparse.ArgumentParser(description="Depth Pro inference (PyTorch/CUDA port)")
    ap.add_argument("-i", "--image-path", dest="image_path", required=True,
                    help="image file or directory")
    ap.add_argument("-o", "--output-path", dest="output_path", default=None)
    ap.add_argument("--half", action="store_true", default=True,
                    help="bfloat16 compute (default)")
    ap.add_argument("--fp32", dest="half", action="store_false")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--speed", choices=sorted(SPEED_PRESETS), default="exact",
                    help="exact, or an approximate ToMe token-merging tier (balanced, fast)")
    ap.add_argument("--model", choices=list(MODEL_PRESETS), default="large",
                    help="model family member")
    ap.add_argument("--exported", default=None,
                    help="an artifact of depth-pro-export-torch: full batches at its shape run "
                         "through it (export with the same --batch-size); on the card it currently starts and runs slower than eager code (PERF.md, ROADMAP B8)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--skip-display", action="store_true", default=False,
                    help="do not open the live matplotlib view")
    run(ap.parse_args(argv))


if __name__ == "__main__":  # pragma: no cover
    main()
