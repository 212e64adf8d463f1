"""Temporal-stability (flicker) metrics for depth-map sequences.

The reference evaluates single images only (`eval/boundary_metrics.py`
— see the reference's `src/depth_pro/eval/boundary_metrics.py`); it has
no notion of video consistency even though its pipeline is a video
batch. Monocular depth flickers frame to frame in two distinct ways,
and these metrics quantify both on any sequence (raw model output, the
`--temporal_smooth` stream, or a `depth-pro-smooth` post-pass):

- **scale jitter**: each frame re-derives its own metric scale through
  the FOV head, so the whole map breathes. Measured as the per-frame
  absolute log-ratio of median inverse depth vs the previous frame.
- **pixel flicker**: per-pixel estimation noise on parts of the scene
  that did not move. Measured as relative inverse-depth change on the
  static set (pixels whose change stays under ``tau`` — the same
  motion gate the smoother uses: real scene motion is not flicker and
  must not be counted against the model).

All statistics work in inverse depth (the model's native output
domain, where noise is closest to uniform).

Copy of ``ml_depth_pro_video_tpu/eval/temporal_metrics.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

_EPS = 1e-6


def _inv(d: np.ndarray) -> np.ndarray:
    return 1.0 / np.clip(np.asarray(d, np.float64), _EPS, 1e6)


def pairwise_flicker(prev: np.ndarray, cur: np.ndarray,
                     tau: float = 0.05) -> dict:
    """Flicker statistics for ONE consecutive pair of (H, W) metric
    depth maps. Returns static-set mean/p95 relative inverse-depth
    change, the static fraction, and the global scale jitter."""
    s_prev, s_cur = _inv(prev), _inv(cur)
    r = np.abs(s_cur - s_prev) / (np.abs(s_prev) + _EPS)
    static = r < tau
    n_static = int(static.sum())
    return {
        "flicker_mean": float(r[static].mean()) if n_static else 0.0,
        "flicker_p95": float(np.percentile(r[static], 95)) if n_static else 0.0,
        "static_fraction": n_static / r.size,
        "scale_jitter": float(abs(np.log(np.median(s_cur) + _EPS)
                                  - np.log(np.median(s_prev) + _EPS))),
    }


def temporal_stability(depths: Iterable[np.ndarray],
                       tau: float = 0.05) -> dict:
    """Aggregate flicker metrics over a depth-map sequence in playback
    order (any iterable of (H, W) metric depth maps; O(1) memory —
    only consecutive pairs are held).

    Returns means over all consecutive pairs:
    ``flicker_mean`` / ``flicker_p95`` (static-set relative
    inverse-depth change), ``static_fraction``, ``scale_jitter``
    (median-inverse-depth log-ratio), and ``frames``. A sequence with
    fewer than 2 frames returns zeros (nothing to compare).
    """
    prev = None
    acc: dict = {}
    pairs = 0
    frames = 0
    for d in depths:
        d = np.asarray(d)
        frames += 1
        if prev is not None and prev.shape == d.shape:
            stats = pairwise_flicker(prev, d, tau=tau)
            pairs += 1
            for k, v in stats.items():
                acc[k] = acc.get(k, 0.0) + v
        prev = d
    out = {k: v / pairs for k, v in acc.items()} if pairs else {
        "flicker_mean": 0.0, "flicker_p95": 0.0,
        "static_fraction": 0.0, "scale_jitter": 0.0}
    out["frames"] = frames
    out["pairs"] = pairs
    return out
