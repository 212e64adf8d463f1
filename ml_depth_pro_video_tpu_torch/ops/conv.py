"""Convolution ops on NHWC activations and HWIO weights.

Twin of ``ml_depth_pro_video_tpu/ops/conv.py``, keeping its layouts at the
public functions: 2x2/s2 transposed convs are one matmul with a
``(Cin, 4*Cout)`` weight packed ``(kh, kw, cout)`` followed by a
depth-to-space. Plain convs go to ``F.conv2d``: an NHWC tensor permuted to
NCHW is already in channels-last memory order, so cuDNN reads it in place.
Everything computes in the input's dtype (fp32 accumulation inside).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int | tuple[int, int] = 1,
           padding: int | tuple[int, int] = 0) -> torch.Tensor:
    """2-D convolution, x: (B, H, W, Cin), w: (kh, kw, Cin, Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 None if b is None else b.to(x.dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def depth_to_space2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4*C) packed (a, b, c) -> (B, 2H, 2W, C)."""
    bsz, h, w, c4 = x.shape
    c = c4 // 4
    y = x.reshape(bsz, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(bsz, 2 * h, 2 * w, c)


def conv_transpose2x2(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """Transposed conv, kernel 2, stride 2, padding 0, as matmul +
    depth-to-space. x: (B, H, W, Cin); w: (Cin, 4*Cout) packed
    (kh, kw, cout). Returns (B, 2H, 2W, Cout)."""
    y = depth_to_space2x2(x @ w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Dense layer, w: (Cin, Cout), in the input's dtype."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _fold_taps() -> np.ndarray:
    """MAP[s, a, a', y] = 1 iff 3x3 tap dy = 2(s-1) + a' - a is in range and
    y = dy + 1 (see ``fold_deconv2x2_conv3x3``)."""
    tap = np.zeros((3, 2, 2, 3), np.float32)
    for s in range(3):
        for a in range(2):
            for ap in range(2):
                dy = 2 * (s - 1) + ap - a
                if abs(dy) <= 1:
                    tap[s, a, ap, dy + 1] = 1.0
    return tap


def fold_deconv2x2_conv3x3(wd: torch.Tensor, bd: torch.Tensor,
                           wc: torch.Tensor) -> torch.Tensor:
    """Fold a 2x2/s2 deconv followed by a 3x3/p1 conv into ONE 3x3 conv at
    the deconv's input resolution over subpixel-packed channels.

    wd: (C, 4*M) matmul-form deconv weight packed (a, b, m); bd: (M,) deconv
    bias; wc: (3, 3, M, N) conv weight. Returns (3, 3, C+1, 4*N) packed
    (a, b, n): ``conv2d(concat([x, ones], -1), folded, padding=1)`` then
    depth-to-space equals ``conv2d(conv_transpose2x2(x, wd, bd), wc,
    padding=1)`` without the 3x3 conv's own bias. The deconv bias rides
    the ones-channel, which keeps the fold exact at the image borders.
    """
    c, m4 = wd.shape
    m = m4 // 4
    n = wc.shape[-1]
    wd4 = wd.reshape(c, 2, 2, m)
    bias_row = bd.reshape(1, 1, 1, m).expand(1, 2, 2, m).to(wd4.dtype)
    wd4 = torch.cat([wd4, bias_row], dim=0)  # (C+1, 2, 2, M)
    tap = torch.as_tensor(_fold_taps(), dtype=wc.dtype, device=wc.device)
    comp = torch.einsum("cpqm,yxmn,sapy,tbqx->stcabn", wd4, wc, tap, tap)
    return comp.reshape(3, 3, c + 1, 4 * n)
