"""Standard dense depth metrics (framework extension; the reference
ships only boundary metrics).

Copy of ``ml_depth_pro_video_tpu/eval/depth_metrics.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np


def _masked(pred, gt, mask):
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if mask is None:
        mask = (gt > 0) & np.isfinite(gt) & np.isfinite(pred)
    return pred[mask], gt[mask]


def abs_rel(pred, gt, mask=None) -> float:
    p, g = _masked(pred, gt, mask)
    return float(np.mean(np.abs(p - g) / g))


def rmse(pred, gt, mask=None) -> float:
    p, g = _masked(pred, gt, mask)
    return float(np.sqrt(np.mean((p - g) ** 2)))


def rmse_log(pred, gt, mask=None) -> float:
    p, g = _masked(pred, gt, mask)
    return float(np.sqrt(np.mean((np.log(p.clip(1e-9)) - np.log(g.clip(1e-9))) ** 2)))


def delta_accuracy(pred, gt, mask=None, threshold: float = 1.25) -> float:
    p, g = _masked(pred, gt, mask)
    ratio = np.maximum(p / g, g / p)
    return float(np.mean(ratio < threshold))


def silog(pred, gt, mask=None, lam: float = 0.85) -> float:
    p, g = _masked(pred, gt, mask)
    d = np.log(p.clip(1e-9)) - np.log(g.clip(1e-9))
    return float(np.mean(d**2) - lam * np.mean(d) ** 2)


def compute_all(pred, gt, mask=None) -> dict:
    return {
        "abs_rel": abs_rel(pred, gt, mask),
        "rmse": rmse(pred, gt, mask),
        "rmse_log": rmse_log(pred, gt, mask),
        "delta1": delta_accuracy(pred, gt, mask, 1.25),
        "delta2": delta_accuracy(pred, gt, mask, 1.25**2),
        "delta3": delta_accuracy(pred, gt, mask, 1.25**3),
        "silog": silog(pred, gt, mask),
    }
