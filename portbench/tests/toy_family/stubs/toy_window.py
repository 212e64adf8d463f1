"""The toy family's program: a runner that streams frames through windows.

Each window holds ``window`` frames, of which the first ``overlap`` are the
last of the window before; a window's answers are those of its new frames.
The whole window runs batched over patch positions and heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SHIFT = 0  # the position in its window that a frame's answer is taken from, less its own


class ToyWindowRunner:
    windows = 0  # windows computed, in every runner of the process

    def __init__(self, weights: dict, arch, dtype):
        self.arch = arch
        self.dtype = dtype
        self.w = {k: v.to(dtype) for k, v in weights.items()}

    def _window(self, frames: torch.Tensor) -> torch.Tensor:
        a, dt = self.arch, self.dtype
        t, h, w, _ = frames.shape
        p, hd = a.patch, a.channels // a.heads
        x = (frames.float() / 127.5 - 1.0).to(dt)
        x = x.reshape(t, h // p, p, w // p, p, 3).permute(1, 3, 0, 2, 4, 5)
        x = x.reshape(-1, t, p * p * 3)                           # (N, T, 48)
        e = (x @ self.w["embed"]).float()
        q, k, v = (e.to(dt) @ self.w["qkv"]).float().reshape(-1, t, 3, a.heads, hd).unbind(2)
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))            # (N, heads, T, hd)
        s = torch.einsum("nhtd,nhsd->nhts", q, k) * hd ** -0.5      # scores in fp32
        att = torch.einsum("nhts,nhsd->nhtd", torch.softmax(s, -1).to(dt), v.to(dt)).float()
        att = att.transpose(1, 2).reshape(-1, t, a.channels)
        e = e + (att.to(dt) @ self.w["out"]).float()
        inv = F.softplus((e.to(dt) @ self.w["head"]).float()[..., 0]) + 0.1   # (N, T)
        inv = inv.T.reshape(t, h // p, w // p)
        ToyWindowRunner.windows += 1
        return inv.repeat_interleave(p, 1).repeat_interleave(p, 2)

    def depth_stream(self, frames):
        """Yield {"inverse_depth", "start", "position"} for each frame of
        ``frames`` ((H, W, 3) uint8), in order, once its window is full:
        ``start`` is the stream index of the window's first frame."""
        a = self.arch
        held, start, first = [], 0, True
        for frame in frames:
            held.append(torch.from_numpy(frame))
            if len(held) < a.window:
                continue
            inv = self._window(torch.stack(held))
            for pos in range(0 if first else a.overlap, a.window):
                yield {"inverse_depth": inv[(pos + SHIFT) % a.window], "start": start,
                       "position": pos}
            first = False
            start += a.window - a.overlap
            held = held[a.window - a.overlap:]
