"""Video Depth Anything (Chen et al., arXiv:2501.12375): consistent relative
depth for long videos, in 32-frame windows.

The model of ``github.com/DepthAnything/Video-Depth-Anything``
(``video_depth_anything/video_depth.py``, ``dpt_temporal.py``, ``dpt.py``,
``motion_module/motion_module.py``, ``dinov2.py``) on the port's param trees
and NHWC tensors:

- a DINOv2 ViT (``models/vit.py``, patch 14) on every frame of the window at
  the frame's network size (the shorter side at ``input_size``, both sides
  multiples of 14: 1080x1920 -> 518x924, a 37x66 grid), its position table
  interpolated once per grid (``vit.interpolate_pos_embed``); the outputs of
  the hooked blocks each through the final LayerNorm, the class token
  dropped;
- a DPT head: 1x1 projections, resize layers (4x4/s4 and 2x2/s2 transposed
  convs as matmuls, identity, a 3x3/s2 conv), 3x3 ``layerN_rn`` convs, four
  fusion blocks whose residual units are K2's form (``ops/resblock.py``),
  bilinear resizes with ``align_corners=True``, the output convs (the last
  two in fp32, as upstream);
- four temporal modules (on the two coarsest reassembled features and after
  the two coarsest fusion blocks): GroupNorm, ``proj_in``, two temporal
  self-attentions and a GEGLU feed-forward, each pre-LN with a residual,
  ``proj_out`` and the module's residual. Attention runs along time at each
  position: the module moves its features to (positions, frames, channels)
  once, adds the sinusoidal position encoding to the normed input, and runs
  K1 (``ops.attention.attention_packed``) on the head-interleaved packed qkv
  at ``temporal_heads`` heads. The LayerNorms and residual adds go through
  ``ops.norm`` (K5 in bf16 on the card).

``window_forward`` maps a window of normalized frames (T, h, w, 3) at the
network size to (T, h, w) relative inverse depth. The windows themselves
(32 frames, of which the first 10 are the previous window's inputs at
``KEYFRAMES``) and the stitching of their outputs (``stitch_window``: a
least-squares scale and shift on the first 2 carried keyframes, then a
linear blend over the 8 overlapping frames) are upstream's
``infer_video_depth``; ``video/runner.py::DepthVideoRunner`` streams them.

In bf16 the ViT, the head's convs and the temporal modules compute in bf16;
LayerNorm and GroupNorm statistics, resizes and ``output_conv2`` stay fp32.
``COUNTERS`` counts windows, frames encoded (new and carried) and the
temporal attention calls that K1 takes. While a ``torch.profiler`` runs, a
window's launches are marked ``vda.encode#w``, ``vda.temporal#w`` and
``vda.head#w`` (``utils/profiling.py::span``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import Precision
from ..ops.attention import attention_packed, kernel_takes
from ..ops.conv import conv2d
from ..ops.norm import add_layer_norm, layer_norm
from ..ops.resblock import residual_block
from ..utils.profiling import span
from .vit import GridViTConfig, ViTConfig, _dense, interpolate_pos_embed, vit_apply

INFER_LEN = 32
KEYFRAMES = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)
INTERP_LEN = 8
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# windows run, frames encoded (new to the stream, carried over), temporal
# attention calls that K1 takes; every model of the process adds to them
COUNTERS = {"windows": 0, "frames_new": 0, "frames_carried": 0, "temporal_k1": 0}


@dataclasses.dataclass(frozen=True)
class VDAConfig:
    """Video Depth Anything's shapes (default: Large, ``video_depth_anything_vitl``)."""

    vit: ViTConfig = ViTConfig(img_size=518, patch_size=14, embed_dim=1024, depth=24,
                               num_heads=16, mlp_ratio=4)
    hook_block_ids: tuple = (4, 11, 17, 23)
    features: int = 256
    out_channels: tuple = (256, 512, 1024, 1024)
    head_features_2: int = 32
    temporal_heads: int = 8
    temporal_max_len: int = 32
    norm_groups: int = 32
    window: int = INFER_LEN
    keyframes: tuple = KEYFRAMES
    interp_len: int = INTERP_LEN
    input_size: int = 518
    checkpoint_uri: str | None = "./checkpoints/video_depth_anything_vitl.pth"

    @property
    def overlap(self) -> int:
        return len(self.keyframes)

    @property
    def step(self) -> int:
        """New frames a window after the first takes."""
        return self.window - self.overlap

    def check(self) -> "VDAConfig":
        if self.hook_block_ids[-1] != self.vit.depth - 1:
            raise ValueError("the last hooked block must be the ViT's last: its tokens are the "
                             "final LayerNorm's")
        if sorted(self.keyframes) != list(self.keyframes) or self.keyframes[-1] >= self.window:
            raise ValueError(f"keyframes must be increasing positions of the window, got "
                             f"{self.keyframes}")
        if not 1 < self.interp_len < self.overlap or self.step < self.interp_len:
            raise ValueError("interp_len must lie between 1 and the overlap, and a window's "
                             "new frames must cover it")
        if self.window > self.temporal_max_len:
            raise ValueError("the window is longer than the temporal position table")
        return self


VDA_LARGE = VDAConfig()
VDA_PRESETS = ("vda_large", "vda_tiny")


def vda_tiny_config() -> VDAConfig:
    """Miniature config for CPU tests: ViT width 64 with 4 blocks, input 28
    (a 2x3 grid for 3:2 frames), the real window and keyframes."""
    return VDAConfig(vit=ViTConfig(img_size=28, patch_size=14, embed_dim=64, depth=4,
                                   num_heads=2, mlp_ratio=2),
                     hook_block_ids=(0, 1, 2, 3), features=64, out_channels=(32, 64, 64, 64),
                     head_features_2=8, input_size=28, checkpoint_uri=None)


def vda_preset(name: str) -> VDAConfig:
    if name == "vda_large":
        return VDA_LARGE
    if name == "vda_tiny":
        return vda_tiny_config()
    raise ValueError(f"Video Depth Anything presets are {VDA_PRESETS}, got {name!r}")


def net_hw(frame_hw: tuple[int, int], input_size: int = 518,
           multiple: int = 14) -> tuple[int, int]:
    """The network size of a frame: upstream's ``Resize(keep_aspect_ratio,
    ensure_multiple_of=14, resize_method="lower_bound")``, after its cut of
    ``input_size`` for frames wider than 1.78:1."""
    h, w = frame_hw
    ratio = max(h, w) / min(h, w)
    if ratio > 1.78:
        input_size = int(round(int(input_size * 1.777 / ratio) / multiple) * multiple)
    scale = max(input_size / h, input_size / w)

    def fit(x: float) -> int:
        y = int(np.round(x / multiple) * multiple)
        return y if y >= input_size else int(np.ceil(x / multiple) * multiple)

    return fit(scale * h), fit(scale * w)


def preprocess(frames: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, h, w, 3) fp32: [0, 1], a bicubic resize
    (``align_corners=False``, no antialias: upstream's cv2 ``INTER_CUBIC``),
    then the ImageNet mean and std."""
    x = frames.permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=hw, mode="bicubic", align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return ((x - mean) / std).permute(0, 2, 3, 1).contiguous()


def resize_ac(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with ``align_corners=True`` of (B, H, W, C), in fp32,
    returned in x's dtype."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=hw, mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def sinusoid_table(length: int, dim: int) -> torch.Tensor:
    """Upstream's ``PositionalEncoding`` buffer (length, dim): sin on the
    even channels, cos on the odd ones."""
    position = torch.arange(length, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


# ---------------------------------------------------------------------------
# layers


def _conv_transpose(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """kxk stride-k transposed conv as a matmul and a depth-to-space; w is
    (Cin, k*k*Cout) packed (kh, kw, cout)."""
    bsz, h, wd, _ = x.shape
    c = w.shape[1] // (k * k)
    y = (x @ w.to(x.dtype)).reshape(bsz, h, wd, k, k, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(bsz, k * h, k * wd, c) + b.to(x.dtype)


def _fusion(p: dict, x: torch.Tensor, skip: torch.Tensor | None,
            hw: tuple[int, int]) -> torch.Tensor:
    """FeatureFusionBlock: (+ unit(skip)), unit, resize to ``hw``, 1x1 conv."""
    if skip is not None:
        r = p["res1"]
        x = x + residual_block(skip, r["w1"], r["b1"], r["w2"], r["b2"])
    r = p["res2"]
    x = residual_block(x, r["w1"], r["b1"], r["w2"], r["b2"])
    return conv2d(resize_ac(x, hw), p["out"]["w"], p["out"]["b"])


def temporal_apply(p: dict, x: torch.Tensor, heads: int, groups: int) -> torch.Tensor:
    """One temporal module on (T, H, W, C): attention along T at each of the
    H*W positions, GroupNorm over ``groups`` groups first."""
    t, h, w, c = x.shape
    cdt = x.dtype
    g = F.group_norm(x.permute(0, 3, 1, 2).float(), groups, p["gn_g"].float(),
                     p["gn_b"].float(), 1e-6)
    # "(b f) d c -> (b d) f c", once for the whole module: rows are positions
    y = g.permute(2, 3, 0, 1).reshape(h * w, t, c).to(cdt)
    y = _dense(y, p["proj_in"]["w"], p["proj_in"]["b"])
    pe = p["pe"][:t].to(cdt)
    ones = p["ones"]
    blocks = p["attn"]
    n = layer_norm(y, blocks[0]["ln_g"], blocks[0]["ln_b"], 1e-5)
    for i, a in enumerate(blocks):
        qkv = (n + pe) @ a["qkv_w"].to(cdt)
        if qkv.is_cuda and kernel_takes(c // heads, cdt):
            COUNTERS["temporal_k1"] += 1
        o = _dense(attention_packed(qkv, heads), a["out_w"], a["out_b"])
        nxt = blocks[i + 1] if i + 1 < len(blocks) else {"ln_g": p["ff_ln_g"],
                                                          "ln_b": p["ff_ln_b"]}
        y, n = add_layer_norm(y, o, ones, nxt["ln_g"], nxt["ln_b"], 1e-5)
    hidden, gate = _dense(n, p["ff1"]["w"], p["ff1"]["b"]).chunk(2, dim=-1)
    y = add_layer_norm(y, _dense(hidden * F.gelu(gate), p["ff2"]["w"], p["ff2"]["b"]), ones)[0]
    y = _dense(y, p["proj_out"]["w"], p["proj_out"]["b"])
    return y.reshape(h, w, t, c).permute(2, 0, 1, 3) + x


def prepare_params(params: dict) -> dict:
    """The tree as the forward reads it: each temporal module with a
    LayerScale of ones for K5's residual adds."""
    head = dict(params["head"])
    head["temporal"] = [{**p, "ones": torch.ones_like(p["proj_in"]["b"])}
                        for p in head["temporal"]]
    return {**params, "head": head}


class VideoDepthAnything:
    """A resident Video Depth Anything model: its param tree, and the ViT's
    position table per grid, interpolated once."""

    def __init__(self, params: dict, cfg: VDAConfig = VDA_LARGE):
        self.cfg = cfg.check()
        self.params = prepare_params(params)
        self._vit = {}  # grid (gh, gw) -> (ViTConfig, ViT tree with that grid's table)

    def vit_at(self, hw: tuple[int, int]) -> tuple[ViTConfig, dict]:
        cfg = self.cfg
        grid = (hw[0] // cfg.vit.patch_size, hw[1] // cfg.vit.patch_size)
        if grid not in self._vit:
            vit = self.params["vit"]
            pos = interpolate_pos_embed(vit["pos_embed"], grid)
            self._vit[grid] = (GridViTConfig(**dataclasses.asdict(cfg.vit), img_hw=tuple(hw)),
                               {**vit, "pos_embed": pos})
        return self._vit[grid]

    def encode(self, x: torch.Tensor, precision: Precision) -> list[torch.Tensor]:
        """(T, h, w, 3) -> the hooked blocks' normed patch tokens, each (T, gh, gw, D)."""
        cfg = self.cfg
        vcfg, vit = self.vit_at(tuple(x.shape[1:3]))
        gh, gw = vcfg.grid_hw
        tokens, caps = vit_apply(vit, x, vcfg, precision, capture_blocks=cfg.hook_block_ids[:-1])
        feats = [layer_norm(c, vit["norm"]["g"], vit["norm"]["b"], vcfg.layer_norm_eps)
                 for c in caps] + [tokens]
        return [f[:, 1:].reshape(f.shape[0], gh, gw, -1) for f in feats]

    def window_forward(self, x: torch.Tensor, precision: Precision = Precision.fp32(),
                       seq: int | None = None) -> torch.Tensor:
        """(T, h, w, 3) normalized frames at the network size -> (T, h, w)
        fp32 relative inverse depth."""
        cfg, hp = self.cfg, self.params["head"]
        t, hh, ww = x.shape[:3]
        cdt = precision.compute_dtype
        x = x.to(cdt)
        tp = hp["temporal"]
        with span("vda.encode", seq):
            feats = self.encode(x, precision)
        with span("vda.head", seq):
            layers = []
            for i, f in enumerate(feats):
                f = conv2d(f, hp["projects"][i]["w"], hp["projects"][i]["b"])
                r = hp["resize"][i]
                if i < 2:
                    f = _conv_transpose(f, r["w"], r["b"], 4 if i == 0 else 2)
                elif i == 3:
                    f = conv2d(f, r["w"], r["b"], stride=2, padding=1)
                layers.append(f)
        with span("vda.temporal", seq):
            layers[2] = temporal_apply(tp[0], layers[2], cfg.temporal_heads, cfg.norm_groups)
            layers[3] = temporal_apply(tp[1], layers[3], cfg.temporal_heads, cfg.norm_groups)
        with span("vda.head", seq):
            rn = [conv2d(f, w, padding=1) for f, w in zip(layers, hp["rn"])]
            fu = hp["fusions"]
            path = _fusion(fu[3], rn[3], None, tuple(rn[2].shape[1:3]))
        with span("vda.temporal", seq):
            path = temporal_apply(tp[2], path, cfg.temporal_heads, cfg.norm_groups)
        with span("vda.head", seq):
            path = _fusion(fu[2], path, rn[2], tuple(rn[1].shape[1:3]))
        with span("vda.temporal", seq):
            path = temporal_apply(tp[3], path, cfg.temporal_heads, cfg.norm_groups)
        with span("vda.head", seq):
            path = _fusion(fu[1], path, rn[1], tuple(rn[0].shape[1:3]))
            path = _fusion(fu[0], path, rn[0], (2 * rn[0].shape[1], 2 * rn[0].shape[2]))
            out = conv2d(path, hp["out1"]["w"], hp["out1"]["b"], padding=1)
            out = resize_ac(out, (hh, ww)).float()
            out = F.relu(conv2d(out, hp["out2a"]["w"], hp["out2a"]["b"], padding=1))
            out = F.relu(conv2d(out, hp["out2b"]["w"], hp["out2b"]["b"]))
        COUNTERS["windows"] += 1
        return out[..., 0]


# ---------------------------------------------------------------------------
# stitching (upstream's infer_video_depth, after the windows)


def scale_shift(pred: torch.Tensor, target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares (scale, shift) of ``pred`` onto ``target`` over every
    element (upstream's ``compute_scale_and_shift_full`` with a mask of
    ones); (1, 0) where the system is singular. Sums in fp64, on the device."""
    p, t = pred.double().flatten(), target.double().flatten()
    a00, a01, a11 = (p * p).sum(), p.sum(), float(p.numel())
    b0, b1 = (p * t).sum(), t.sum()
    det = a00 * a11 - a01 * a01
    ok = det != 0
    safe = torch.where(ok, det, torch.ones_like(det))
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / safe, torch.ones_like(det))
    shift = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, torch.zeros_like(det))
    return scale.float(), shift.float()


def stitch_window(state: dict | None, raw: torch.Tensor, cfg: VDAConfig,
                  last: bool = False) -> tuple[dict, torch.Tensor, list[int]]:
    """One window's raw output (T, H, W) at the frame size into the stitched
    stream. Returns (the state for the next window, the frames final now,
    their positions in this window, or -1 for the frames held over from the
    window before). A window holds back its last ``interp_len`` frames for
    the next window's blend; ``last`` releases them."""
    t, keys, il = raw.shape[0], cfg.keyframes, cfg.interp_len
    align = cfg.overlap - il
    held_pos = list(range(t - il, t))
    if state is None:
        aligned = raw
        ref = raw[list(keys[:align])]
        done, done_pos = aligned[:t - il], list(range(t - il))
    else:
        scale, shift = scale_shift(raw[:align], state["ref"])

        def fit(z):
            return torch.clamp(z * scale + shift, min=0.0)

        post = fit(raw[align:cfg.overlap])
        wts = torch.linspace(0.0, 1.0, il, device=raw.device).view(il, 1, 1)
        blended = state["held"] * (1.0 - wts) + post * wts
        aligned = torch.cat([raw[:cfg.overlap], fit(raw[cfg.overlap:])])
        ref = torch.cat([state["ref"][:1], fit(raw[list(keys[1:align])])])
        done = torch.cat([blended, aligned[cfg.overlap:t - il]])
        done_pos = [-1] * il + list(range(cfg.overlap, t - il))
    if last:
        done = torch.cat([done, aligned[t - il:]])
        done_pos = done_pos + held_pos
    return {"ref": ref, "held": aligned[t - il:]}, done, done_pos
