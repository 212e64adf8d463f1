"""``depth-pro-smooth-torch``: temporal smoothing of saved depth-map sequences.

Same behaviour as the JAX package's ``depth-pro-smooth``
(``ml_depth_pro_video_tpu/cli/smooth_depth.py``). A run that cannot smooth
inline writes per-frame metric ``.npz`` maps (``depth-pro-maps-torch
--save_npz``), then

  depth-pro-smooth-torch maps_dir/ --output_dir smoothed/

smooths the sequence with ``video/temporal.py`` (scale and shift alignment in
inverse depth, then an EMA gated on motion: the filter of ``--temporal_smooth``)
in frame-number order, lexicographic where names carry no number.
``--device`` picks the card (default ``cuda``).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from ..video.temporal import smooth_depth_files


def frame_number(path: str) -> int | None:
    """The digits of a file name as one number (frame_12.png -> 12), or None."""
    digits = "".join(ch for ch in os.path.basename(path) if ch.isdigit())
    return int(digits) if digits else None


def _ordered(paths: list[str]) -> list[str]:
    """Playback order: numeric where names embed a frame number (frame_2
    before frame_10), lexicographic otherwise."""

    def key(p: str):
        n = frame_number(os.path.basename(p))
        return (0, n, p) if n is not None else (1, 0, p)

    return sorted(paths, key=key)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Temporal smoothing post-pass over saved depth maps (PyTorch port)")
    ap.add_argument("input", help="directory of .npz/.npy depth maps")
    ap.add_argument("-o", "--output_dir", default=None,
                    help="write smoothed maps here (same basenames); default: rewrite each "
                         "file in place")
    ap.add_argument("--pattern", default="*.npz",
                    help="glob under the input directory (default *.npz; use '*_depth.npz' "
                         "for depth-pro-maps-torch output)")
    ap.add_argument("--alpha", type=float, default=0.8,
                    help="EMA history weight on static pixels (0.8 is about a 5-frame memory)")
    ap.add_argument("--tau", type=float, default=0.05,
                    help="relative inverse-depth change above which a pixel counts as motion "
                         "and passes through")
    ap.add_argument("--no_align", action="store_true",
                    help="skip the per-frame global scale+shift fit")
    ap.add_argument("--key", default="depth", help="npz array name holding the depth map")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    if not os.path.isdir(args.input):
        sys.exit(f"not a directory: {args.input}")
    paths = _ordered(glob.glob(os.path.join(args.input, args.pattern)))
    if not paths:
        sys.exit(f"no {args.pattern} files under {args.input}")
    n = smooth_depth_files(paths, output_dir=args.output_dir, alpha=args.alpha, tau=args.tau,
                           align=not args.no_align, key=args.key, device=args.device)
    dest = args.output_dir or f"{args.input} (in place)"
    logging.getLogger(__name__).info("smoothed %d depth maps -> %s", n, dest)


if __name__ == "__main__":  # pragma: no cover
    main()
