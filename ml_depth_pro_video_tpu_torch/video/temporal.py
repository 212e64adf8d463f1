"""Temporal depth smoothing for video streams.

Twin of ``ml_depth_pro_video_tpu/video/temporal.py``. Monocular depth run
frame by frame flickers: each frame re-derives its metric scale through the
FOV head, and every pixel carries its own noise. The smoother:

1. works in inverse depth;
2. aligns the incoming frame to the running state with a global scale and
   shift, fitted in closed form (centered weighted least squares) over the
   pixels that did not move;
3. blends with an EMA only where the aligned frame agrees with the state
   (relative change below ``tau``); real motion passes through untouched and
   re-seeds the state, so nothing leaves a trail.

``smooth_batch`` is the runner's form: a loop over a batch of device rows in
playback order with the state kept on the device. It stays on tensors
throughout (``torch.where``, no Python test of a device value), so it never
waits for the card and the runner's pipeline keeps its depth.
``_update_core_np`` is the host twin of the update, and the oracle of the
device form. ``TemporalSmoother`` smooths one frame at a time, on the device
or (``host=True``) on the host; ``smooth_depth_files`` is the post-pass over
saved maps behind ``depth-pro-smooth-torch``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.precision import resolve_device


def _update_core(state: torch.Tensor, depth: torch.Tensor, *, alpha: float, tau: float,
                 align: bool):
    """One smoothing step on the device. state/depth: (H, W) metric depth.
    Returns (new_state, smoothed_depth), both (H, W) fp32."""
    eps = 1e-6
    s = 1.0 / depth.float().clamp(eps, 1e6)   # inverse depth
    ref = 1.0 / state.float().clamp(eps, 1e6)

    if align:
        # static-pixel mask for the fit (before alignment, a loose 2*tau band)
        w = ((s - ref).abs() / (ref.abs() + eps) < 2.0 * tau).float()
        n = w.sum()
        nsafe = n.clamp_min(1.0)
        # centered (covariance-form) weighted least squares: the raw normal
        # equations (n*sum(w s^2) - sum(w s)^2) cancel catastrophically in fp32
        # at inverse depths ~1e-4; det = n * sum(w (s - mean)^2) in exact math
        m_s = (w * s).sum() / nsafe
        m_r = (w * ref).sum() / nsafe
        ds_c = s - m_s
        dr_c = ref - m_r
        var = (w * ds_c * ds_c).sum()
        cov = (w * ds_c * dr_c).sum()
        det = n * var
        a = cov / torch.where(det > eps, var, torch.ones_like(var))
        b = m_r - a * m_s
        # a degenerate fit (few static pixels, a flat scene) or a scale far
        # from 1 (a scene cut, not flicker) keeps the frame as it is; the
        # per-pixel gate below then re-seeds the state
        ok = (det > eps) & (n > 0.01 * s.numel()) & (a > 0.5) & (a < 2.0)
        s = torch.where(ok, a * s + b, s)

    static = (s - ref).abs() / (ref.abs() + eps) < tau
    blended = torch.where(static, alpha * ref + (1.0 - alpha) * s, s)
    out = 1.0 / blended.clamp(eps, 1e6)
    return out, out


def _update_core_np(state: np.ndarray, depth: np.ndarray, *, alpha: float, tau: float,
                    align: bool):
    """Host (numpy) twin of :func:`_update_core`, the same math in fp32."""
    eps = np.float32(1e-6)
    s = np.float32(1.0) / np.clip(depth.astype(np.float32), eps, 1e6)
    ref = np.float32(1.0) / np.clip(state.astype(np.float32), eps, 1e6)

    if align:
        w = (np.abs(s - ref) / (np.abs(ref) + eps) < 2.0 * tau).astype(np.float32)
        n = np.sum(w)
        nsafe = max(n, 1.0)
        # centered form, as on the device (see the comment there)
        m_s = np.sum(w * s) / nsafe
        m_r = np.sum(w * ref) / nsafe
        ds_c = s - m_s
        dr_c = ref - m_r
        var = np.sum(w * ds_c * ds_c)
        cov = np.sum(w * ds_c * dr_c)
        det = n * var
        a = cov / (var if det > eps else 1.0)
        b = m_r - a * m_s
        ok = (det > eps) and (n > 0.01 * s.size) and (0.5 < a < 2.0)
        if ok:
            s = a * s + b
    static = np.abs(s - ref) / (np.abs(ref) + eps) < tau
    blended = np.where(static, alpha * ref + (1.0 - alpha) * s, s)
    out = np.float32(1.0) / np.clip(blended, eps, 1e6)
    return out, out


def _check_alpha(alpha: float) -> None:
    # alpha=1 freezes every static pixel at the seed frame; alpha>1
    # extrapolates with a negative weight on the current frame
    if not 0.0 <= alpha < 1.0:
        raise ValueError(f"alpha must be in [0, 1), got {alpha}")


def smooth_batch(state: torch.Tensor | None, depths: torch.Tensor, n: int | None = None, *,
                 alpha: float, tau: float = 0.05, align: bool = True):
    """Smooth the first ``n`` rows of ``depths`` (B, H, W) in playback order,
    on their device. Rows from ``n`` on (batch padding) pass through and
    leave the state as it is. Returns ``(new_state, smoothed (B, H, W) fp32)``,
    both on the device, so smoothing adds no host-device traffic.

    ``state=None`` (or a resolution change) re-seeds from the first frame,
    which passes through unchanged: frame for frame the semantics of
    :class:`TemporalSmoother`.
    """
    _check_alpha(alpha)
    b = depths.shape[0]
    n = b if n is None else n
    first = 0
    if state is None or state.shape != depths.shape[1:]:
        state = depths[0].float()
        first = 1
    rows = []
    for i in range(b):
        if first <= i < n:
            state, out = _update_core(state, depths[i], alpha=alpha, tau=tau, align=align)
        else:
            out = depths[i].float()
        rows.append(out)
    return state, torch.stack(rows)


class TemporalSmoother:
    """Feed metric depth maps in playback order; get them back smoothed.

    ``alpha``: EMA weight of the history on static pixels (0 disables the
    blend; 0.8 is about a 5-frame memory). ``tau``: relative inverse-depth
    change above which a pixel counts as motion and passes through.
    ``align``: fit the global scale and shift each frame. A resolution change
    (or ``reset()``) re-seeds the state.

    ``host=True`` runs the numpy twin on the host; otherwise the update runs
    on ``device`` (default ``cuda``).
    """

    def __init__(self, alpha: float = 0.8, tau: float = 0.05, align: bool = True,
                 host: bool = False, device="cuda"):
        _check_alpha(alpha)
        self.alpha = float(alpha)
        self.tau = float(tau)
        self.align = bool(align)
        self.host = bool(host)
        self.device = None if self.host else resolve_device(device)
        self._state = None

    def reset(self) -> None:
        self._state = None

    def update(self, depth) -> np.ndarray:
        """depth: (H, W) metric depth (numpy or torch). Returns the smoothed
        (H, W) fp32 numpy map."""
        if self.host:
            d = np.asarray(depth)
            if self._state is None or self._state.shape != d.shape:
                self._state = np.asarray(d, np.float32)
                return self._state
            self._state, out = _update_core_np(self._state, d, alpha=self.alpha, tau=self.tau,
                                               align=self.align)
            return out
        d = torch.as_tensor(depth, device=self.device)
        if self._state is None or self._state.shape != d.shape:
            self._state = d.float()
            return self._state.cpu().numpy()
        self._state, out = _update_core(self._state, d, alpha=self.alpha, tau=self.tau,
                                        align=self.align)
        return out.cpu().numpy()


def smooth_depth_files(paths, output_dir: str | None = None, alpha: float = 0.8,
                       tau: float = 0.05, align: bool = True, key: str = "depth",
                       chunk: int = 16, device="cuda") -> int:
    """Smooth saved depth maps in the given order (the post-pass for runs
    that cannot smooth inline).

    ``paths``: depth files in playback order, ``.npz`` (smooths array ``key``
    and copies every other array through) or ``.npy`` (the bare array).
    ``output_dir=None`` rewrites each file in place by an atomic replace;
    otherwise the same basename is written under ``output_dir``. Frames go
    to ``device`` in batches of ``chunk`` (:func:`smooth_batch`, the same
    output as frame by frame); a resolution change flushes the open batch
    and re-seeds. Returns the number of files written.
    """
    # before any file is rewritten: smooth_batch would raise only after the
    # first flush had opened temp files
    _check_alpha(alpha)
    dev = resolve_device(device)
    state = None
    written = 0
    buf: list = []  # (out_path, tmp, payload or None, depth) per open frame

    def flush():
        nonlocal state, written
        if not buf:
            return
        depths = torch.as_tensor(np.stack([b[3] for b in buf]).astype(np.float32), device=dev)
        state, smoothed = smooth_batch(state, depths, len(buf), alpha=alpha, tau=tau,
                                       align=align)
        out = smoothed.cpu().numpy()
        for i, (out_path, tmp, payload, d) in enumerate(buf):
            arr = out[i].astype(d.dtype, copy=False)
            # write through an open handle: np.save/savez append their
            # extension to a bare path, and a temp name such as X.npz.tmp.npz
            # would match the globs that feed a rerun of this pass; a crash
            # mid-flush would then feed a stale temp into the rerun's EMA.
            # "X.npz.tmp" matches no depth-map pattern.
            with open(tmp, "wb") as f:
                if payload is None:  # .npy
                    np.save(f, arr)
                else:
                    payload[key] = arr
                    np.savez_compressed(f, **payload)
            os.replace(tmp, out_path)
            written += 1
        buf.clear()

    for path in paths:
        if output_dir is None:
            out_path = path
        else:
            os.makedirs(output_dir, exist_ok=True)
            out_path = os.path.join(output_dir, os.path.basename(path))
        if path.endswith(".npy"):
            d, payload = np.load(path), None
        else:
            with np.load(path) as z:
                payload = {k: z[k] for k in z.files}
            if key not in payload:
                raise KeyError(f"{path} has no array {key!r} (found {sorted(payload)})")
            d = payload[key]
        if buf and d.shape != buf[-1][3].shape:
            flush()  # homogeneous batches; smooth_batch re-seeds after
        buf.append((out_path, out_path + ".tmp", payload, d))
        if len(buf) >= max(chunk, 1):
            flush()
    flush()
    return written
