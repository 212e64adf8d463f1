"""Evaluate predicted depth maps against ground truth.

CLI wrapper over the metrics layer the reference exposes only as a
library (the reference's `src/depth_pro/eval/boundary_metrics.py`,
the reference README's usage, `README.md:60-70`): scale-invariant
boundary F1 plus the standard dense depth metrics
(`eval/depth_metrics.py`, a framework extension).

Inputs are files or directories; directory mode pairs prediction and
ground-truth files by basename stem (a `_depth` suffix on predictions
is ignored, matching `depth-pro-maps --save_npz` output names).
Supported formats: `.npz` (key ``depth``, or the only array), `.npy`,
and 16-bit PNG with ``--gt-scale`` meters-per-unit.

Copy of ``ml_depth_pro_video_tpu/cli/eval_depth.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..eval.boundary_metrics import SI_boundary_F1
from ..eval.depth_metrics import compute_all


def load_depth(path: str, scale: float = 1.0) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            key = "depth" if "depth" in z.files else z.files[0]
            return np.asarray(z[key], dtype=np.float64)
    if ext == ".npy":
        return np.asarray(np.load(path), dtype=np.float64)
    if ext in (".png", ".tif", ".tiff"):
        from PIL import Image

        arr = np.asarray(Image.open(path), dtype=np.float64)
        if arr.ndim == 3:  # colormapped PNGs are not evaluable
            raise ValueError(f"{path}: multi-channel image is not a depth map")
        return arr * scale
    raise ValueError(f"unsupported depth format: {path}")


def _stem(path: str) -> str:
    s = os.path.splitext(os.path.basename(path))[0]
    return s[: -len("_depth")] if s.endswith("_depth") else s


def collect_pairs(pred: str, gt: str) -> list[tuple[str, str]]:
    exts = ("*.npz", "*.npy", "*.png", "*.tif", "*.tiff")
    gts = (
        {_stem(p): p for e in exts for p in glob.glob(os.path.join(gt, e))}
        if os.path.isdir(gt)
        else None
    )
    if os.path.isfile(pred):
        if gts is None:
            return [(pred, gt)]
        stem = _stem(pred)
        if stem not in gts:
            raise SystemExit(f"no ground truth named like '{stem}' in {gt}")
        return [(pred, gts[stem])]
    preds = sorted(p for e in exts for p in glob.glob(os.path.join(pred, e)))
    if gts is None:
        raise SystemExit("--pred is a directory; --gt must be one too")
    pairs = [(p, gts[_stem(p)]) for p in preds if _stem(p) in gts]
    if not pairs:
        raise SystemExit(f"no prediction/ground-truth basename matches between {pred} and {gt}")
    return pairs


def evaluate_pair(pred_path: str, gt_path: str, gt_scale: float,
                  boundary_t: int = 10) -> dict:
    pred = load_depth(pred_path)
    gt = load_depth(gt_path, scale=gt_scale)
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch: {pred_path} {pred.shape} vs {gt_path} {gt.shape}")
    mask = (gt > 0) & np.isfinite(gt) & np.isfinite(pred) & (pred > 0)
    metrics = compute_all(pred, gt, mask)
    # SI_boundary_F1 takes metric depth and inverts internally. It needs
    # DENSE ground truth: holes (gt == 0) would register as huge inverse-
    # depth edges at every valid/invalid border and swamp the metric, so
    # it is only reported when the GT is (nearly) dense.
    if mask.mean() > 0.99:
        metrics["SI_boundary_F1"] = float(SI_boundary_F1(pred, gt, N=boundary_t))
    return metrics


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Evaluate depth predictions (PyTorch port)")
    ap.add_argument("--pred", required=True, help="prediction file or directory")
    ap.add_argument("--gt", default=None,
                    help="ground-truth file or directory (not needed "
                         "with --temporal)")
    ap.add_argument("--gt-scale", type=float, default=1.0,
                    help="meters per ground-truth unit (for 16-bit PNG GT)")
    ap.add_argument("--boundary-t", type=int, default=10,
                    help="N thresholds for the SI boundary sweep (reference N=10)")
    ap.add_argument("--per-image", action="store_true", help="print one JSON line per pair")
    ap.add_argument("--temporal", action="store_true",
                    help="evaluate TEMPORAL stability instead: --pred is "
                         "a depth-map sequence directory (played in "
                         "frame-number order, no ground truth needed); "
                         "reports static-set flicker + scale jitter "
                         "(eval/temporal_metrics.py)")
    ap.add_argument("--tau", type=float, default=0.05,
                    help="motion gate for --temporal: relative inverse-"
                         "depth change above this counts as real motion, "
                         "not flicker (matches --temporal_smooth's gate)")
    ap.add_argument("--pattern", default=None,
                    help="glob for --temporal frame files (e.g. "
                         "'*_depth.npz'); default: all known depth "
                         "formats, one per frame stem (npz preferred)")
    args = ap.parse_args(argv)

    if args.temporal:
        from ..eval.temporal_metrics import temporal_stability

        if not os.path.isdir(args.pred):
            raise SystemExit("--temporal evaluates a sequence: --pred "
                             "must be a directory of depth maps")
        if args.pattern is not None:
            paths = glob.glob(os.path.join(args.pred, args.pattern))
        else:
            # depth-pro-maps writes BOTH {stem}_depth.npz and a
            # colormapped {stem}_depth.png per frame: keep ONE file per
            # stem (metric formats preferred) — feeding both would
            # crash load_depth on the RGB png, or double-count frames
            # and bias the flicker stats toward 0
            pref = {".npz": 0, ".npy": 1, ".png": 2, ".tif": 3, ".tiff": 3}
            by_stem: dict = {}
            for e in sorted(pref):
                for p in glob.glob(os.path.join(args.pred, "*" + e)):
                    stem, ext = os.path.splitext(p)
                    cur = by_stem.get(stem)
                    if cur is None or pref[ext.lower()] < pref[
                            os.path.splitext(cur)[1].lower()]:
                        by_stem[stem] = p
            paths = list(by_stem.values())
        if len(paths) < 2:
            raise SystemExit(f"need at least 2 depth maps under {args.pred}")
        from .smooth_depth import _ordered

        stats = temporal_stability(
            (load_depth(p, scale=args.gt_scale) for p in _ordered(paths)),
            tau=args.tau)
        print(json.dumps({k: round(v, 6) if isinstance(v, float) else v
                          for k, v in stats.items()}))
        return

    if args.gt is None:
        raise SystemExit("--gt is required (or pass --temporal for "
                         "sequence-stability evaluation)")
    pairs = collect_pairs(args.pred, args.gt)
    rows = []
    for pred_path, gt_path in pairs:
        m = evaluate_pair(pred_path, gt_path, args.gt_scale, args.boundary_t)
        rows.append(m)
        if args.per_image:
            print(json.dumps({"pred": os.path.basename(pred_path), **{k: round(v, 6) for k, v in m.items()}}))
    keys = [k for k in rows[0] if all(k in r for r in rows)] + sorted(
        {k for r in rows for k in r} - set(rows[0])
    )
    mean = {k: round(float(np.mean([r[k] for r in rows if k in r])), 6) for k in keys}
    print(json.dumps({"n_images": len(rows), **mean}))


if __name__ == "__main__":  # pragma: no cover
    main()
