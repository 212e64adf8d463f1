"""Plain PyTorch Video Depth Anything: the yardstick that decides a run's
``correct`` for the ``video_depth_anything`` family.

A copy of the model's plain math as upstream writes it (Chen et al.,
arXiv:2501.12375; ``github.com/DepthAnything/Video-Depth-Anything``:
``video_depth_anything/video_depth.py``, ``dpt_temporal.py``, ``dpt.py``,
``motion_module/motion_module.py``, ``dinov2.py``), on a state dict in
upstream's module layout (``portbench/weights_vda.py`` makes one from the
seed), NCHW, one 32-frame window at a time:

- each frame resized bicubically to its network size and normalised;
- DINOv2: a 14x14/s14 patch conv, the class token, the position table
  interpolated by ``F.interpolate(scale_factor=...)`` as ``dinov2.py``'s
  ``interpolate_pos_encoding`` calls it, pre-norm blocks with LayerScale; the
  hooked blocks' outputs through the final LayerNorm, the class token dropped;
- the DPT head with its four temporal modules, exactly in upstream's order;
- the window's output resized to the frame size (bilinear,
  ``align_corners=True``).

Departures from upstream, each noted where it is made: the input resize is
``F.interpolate``'s bicubic, not cv2's ``INTER_CUBIC`` (the same kernel, a
= -0.75, half-pixel centres, no antialias; the edge taps are clamped here);
precision follows the configuration's ``dtype`` instead of autocast: matmuls
and convolutions in ``dtype`` with fp32 accumulation, LayerNorm and GroupNorm
statistics, resizes, attention scores and softmax, and ``output_conv2`` in
fp32 (upstream leaves only ``output_conv2`` outside autocast); the
positional encoding is added to the normed input in ``dtype``.

There is no kernel, cache or batching trick: attention is ``softmax(q k^T)
v``, every convolution is ``F.conv2d``, and frames go through the ViT and the
high-resolution layers of the head in blocks of ``block`` frames only to bound
memory. TF32 is off for the whole call. It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Arch:
    """The shapes of one Video Depth Anything configuration."""

    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    pretrain_size: int = 518             # the position table's image size (37x37 patches)
    hooks: tuple = (4, 11, 17, 23)
    features: int = 256
    out_channels: tuple = (256, 512, 1024, 1024)
    head_features_2: int = 32
    temporal_heads: int = 8
    temporal_max_len: int = 32
    norm_groups: int = 32
    window: int = 32
    keyframes: tuple = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)
    interp_len: int = 8
    input_size: int = 518
    frame_hw: tuple = (1080, 1920)        # the benchmark's frames (assumed, not published)
    layer_norm_eps: float = 1e-6

    @property
    def overlap(self) -> int:
        return len(self.keyframes)

    @property
    def step(self) -> int:
        return self.window - self.overlap

    @property
    def net_hw(self) -> tuple[int, int]:
        return net_hw(self.frame_hw, self.input_size, self.patch_size)

    @property
    def grid_hw(self) -> tuple[int, int]:
        h, w = self.net_hw
        return h // self.patch_size, w // self.patch_size

    @property
    def tokens(self) -> int:
        gh, gw = self.grid_hw
        return gh * gw + 1


def arch_of(config: dict) -> Arch:
    """The ``Arch`` of a configuration file's ``model`` group (and the frame
    size it ``assumed``)."""
    m = config["model"]
    return Arch(patch_size=m["patch_size"], embed_dim=m["embed_dim"], depth=m["depth"],
                num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
                pretrain_size=m["pretrain_size"], hooks=tuple(m["intermediate_layer_idx"]),
                features=m["features"], out_channels=tuple(m["out_channels"]),
                head_features_2=m["head_features_2"], temporal_heads=m["num_attention_heads"],
                temporal_max_len=m["temporal_max_len"], norm_groups=m["norm_num_groups"],
                window=m["infer_len"], keyframes=tuple(m["keyframes"]),
                interp_len=m["interp_len"], input_size=m["input_size"],
                frame_hw=tuple(config["assumed"]["frame_size"]))


def net_hw(frame_hw, input_size: int = 518, multiple: int = 14) -> tuple[int, int]:
    """Upstream's ``Resize(width=height=input_size, keep_aspect_ratio=True,
    ensure_multiple_of=14, resize_method="lower_bound")`` of ``transform.py``,
    after ``infer_video_depth``'s cut of ``input_size`` for frames wider than
    1.78:1."""
    h, w = frame_hw
    ratio = max(h, w) / min(h, w)
    if ratio > 1.78:
        input_size = int(input_size * 1.777 / ratio)
        input_size = round(input_size / 14) * 14
    scale = max(input_size / h, input_size / w)

    def constrain(x):
        y = int(np.round(x / multiple) * multiple)
        return y if y >= input_size else int(np.ceil(x / multiple) * multiple)

    return constrain(scale * h), constrain(scale * w)


def window_frames(w: int, window: int = 32, keyframes: tuple = (0, 12, 24, 25, 26, 27, 28,
                                                                 29, 30, 31)) -> list[int]:
    """Stream indices of window ``w``'s inputs, by ``infer_video_depth``'s
    loop: window ``w`` reads frames from ``w * step`` on, and its first
    ``len(keyframes)`` inputs are the window before's at ``keyframes``."""
    step = window - len(keyframes)
    cur = list(range(window))
    for i in range(1, w + 1):
        nxt = list(range(i * step, i * step + window))
        nxt[:len(keyframes)] = [cur[k] for k in keyframes]
        cur = nxt
    return cur


@contextlib.contextmanager
def no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ---------------------------------------------------------------------------
# layers: NCHW activations in ``dtype``, upstream's weight layouts


def linear(x, sd, key, dtype, bias=True):
    return F.linear(x.to(dtype), sd[f"{key}.weight"].to(dtype),
                    sd[f"{key}.bias"].to(dtype) if bias else None)


def conv(x, sd, key, dtype, bias=True, **kw):
    return F.conv2d(x.to(dtype), sd[f"{key}.weight"].to(dtype),
                    sd[f"{key}.bias"].to(dtype) if bias else None, **kw)


def layer_norm(x, sd, key, eps):
    w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps).to(x.dtype)


def group_norm(x, sd, key, groups):
    w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
    return F.group_norm(x.float(), groups, w.float(), b.float(), 1e-6).to(x.dtype)


def attention(q, k, v):
    """(B, H, S, hd) each; scores and softmax in fp32, the probabilities in
    v's dtype times v."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.softmax(scores, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(v.dtype)


def resize(x, size=None, scale_factor=None, mode="bilinear", align_corners=True):
    """F.interpolate in fp32, returned in x's dtype."""
    return F.interpolate(x.float(), size=size, scale_factor=scale_factor, mode=mode,
                         align_corners=align_corners).to(x.dtype)


# ---------------------------------------------------------------------------
# DINOv2


def pos_table(sd, grid_hw):
    """``interpolate_pos_encoding``: the pretrained table's patch rows
    through ``F.interpolate(scale_factor=((gh + 0.1) / G, (gw + 0.1) / G),
    mode="bicubic", antialias=False)``, in fp32."""
    pos = sd["pretrained.pos_embed"].float()
    n = pos.shape[1] - 1
    g = int(math.sqrt(n))
    gh, gw = grid_hw
    if (gh, gw) == (g, g):
        return pos
    d = pos.shape[-1]
    patch = pos[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
    patch = F.interpolate(patch, scale_factor=((gh + 0.1) / g, (gw + 0.1) / g), mode="bicubic",
                          antialias=False)
    assert patch.shape[-2:] == (gh, gw), patch.shape
    return torch.cat([pos[:, :1], patch.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], dim=1)


def vit_features(sd, x, arch: Arch, dtype):
    """(B, 3, h, w) normalised -> the hooked blocks' normed patch tokens,
    each (B, D, gh, gw)."""
    b = x.shape[0]
    gh, gw = x.shape[2] // arch.patch_size, x.shape[3] // arch.patch_size
    t = conv(x, sd, "pretrained.patch_embed.proj", dtype, stride=arch.patch_size)
    t = t.flatten(2).transpose(1, 2)
    cls = sd["pretrained.cls_token"].to(dtype).expand(b, -1, -1)
    t = torch.cat([cls, t], dim=1) + pos_table(sd, (gh, gw)).to(dtype)
    heads, d = arch.num_heads, arch.embed_dim
    out = []
    for i in range(arch.depth):
        p = f"pretrained.blocks.{i}."
        h = layer_norm(t, sd, p + "norm1", arch.layer_norm_eps)
        qkv = linear(h, sd, p + "attn.qkv", dtype)
        q, k, v = qkv.reshape(b, -1, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        a = attention(q, k, v).transpose(1, 2).reshape(b, -1, d)
        t = t + sd[p + "ls1.gamma"].to(dtype) * linear(a, sd, p + "attn.proj", dtype)
        h = layer_norm(t, sd, p + "norm2", arch.layer_norm_eps)
        h = F.gelu(linear(h, sd, p + "mlp.fc1", dtype))
        t = t + sd[p + "ls2.gamma"].to(dtype) * linear(h, sd, p + "mlp.fc2", dtype)
        if i in arch.hooks:
            n = layer_norm(t, sd, "pretrained.norm", arch.layer_norm_eps)
            out.append(n[:, 1:].transpose(1, 2).reshape(b, d, gh, gw))
    return out


# ---------------------------------------------------------------------------
# DPT head with temporal modules


def temporal_module(sd, key, x, t_len, arch: Arch, dtype):
    """``TemporalModule`` on (B*T, C, h, w)."""
    bt, c, h, w = x.shape
    residual = x
    y = group_norm(x, sd, f"{key}.norm", arch.norm_groups)
    y = y.permute(0, 2, 3, 1).reshape(bt, h * w, c)
    y = linear(y, sd, f"{key}.proj_in", dtype)
    blk = f"{key}.transformer_blocks.0"
    heads = arch.temporal_heads
    for j in range(2):
        a = f"{blk}.attention_blocks.{j}"
        n = layer_norm(y, sd, f"{blk}.norms.{j}", 1e-5)       # nn.LayerNorm's eps
        d = n.shape[1]
        n = n.reshape(bt // t_len, t_len, d, c).transpose(1, 2).reshape(-1, t_len, c)
        n = n + sd[f"{a}.pos_encoder.pe"][:, :t_len].to(dtype)
        q, k, v = (linear(n, sd, f"{a}.to_{m}", dtype, bias=False) for m in "qkv")
        q, k, v = (z.reshape(-1, t_len, heads, c // heads).transpose(1, 2) for z in (q, k, v))
        o = attention(q, k, v).transpose(1, 2).reshape(-1, t_len, c)
        o = linear(o, sd, f"{a}.to_out.0", dtype)
        o = o.reshape(bt // t_len, d, t_len, c).transpose(1, 2).reshape(bt, d, c)
        y = o + y
    n = layer_norm(y, sd, f"{blk}.ff_norm", 1e-5)
    hidden, gate = linear(n, sd, f"{blk}.ff.net.0.proj", dtype).chunk(2, dim=-1)
    y = linear(hidden * F.gelu(gate), sd, f"{blk}.ff.net.2", dtype) + y
    y = linear(y, sd, f"{key}.proj_out", dtype)
    return y.reshape(bt, h, w, c).permute(0, 3, 1, 2) + residual


def residual_unit(sd, key, x, dtype):
    out = conv(F.relu(x), sd, f"{key}.conv1", dtype, padding=1)
    out = conv(F.relu(out), sd, f"{key}.conv2", dtype, padding=1)
    return out + x


def fusion(sd, i, x, skip, size, dtype):
    key = f"head.scratch.refinenet{i}"
    if skip is not None:
        x = x + residual_unit(sd, f"{key}.resConfUnit1", skip, dtype)
    x = residual_unit(sd, f"{key}.resConfUnit2", x, dtype)
    x = resize(x, size=size) if size is not None else resize(x, scale_factor=2)
    return conv(x, sd, f"{key}.out_conv", dtype)


def in_blocks(fn, n, block):
    return torch.cat([fn(slice(i, i + block)) for i in range(0, n, block)])


def infer_window(sd: dict, frames: torch.Tensor, arch: Arch, dtype, block: int = 4):
    """(T, H, W, 3) uint8 frames of one window (its inputs, the carried
    keyframes first) -> (T, H, W) fp32 relative inverse depth at the frame
    size, unstitched."""
    with no_tf32(), torch.no_grad():
        return _infer_window(sd, frames, arch, dtype, block)


def _infer_window(sd, frames, arch: Arch, dtype, block):
    t_len, fh, fw = frames.shape[:3]
    h, w = net_hw((fh, fw), arch.input_size, arch.patch_size)
    gh, gw = h // arch.patch_size, w // arch.patch_size
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=frames.device).view(1, 3, 1, 1)

    def encode(sl):
        x = frames[sl].permute(0, 3, 1, 2).float() / 255.0
        x = F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)
        x = (x - mean) / std
        out = []
        for i, f in enumerate(vit_features(sd, x, arch, dtype)):
            f = conv(f, sd, f"head.projects.{i}", dtype)
            if i < 2:
                f = F.conv_transpose2d(f, sd[f"head.resize_layers.{i}.weight"].to(dtype),
                                       sd[f"head.resize_layers.{i}.bias"].to(dtype),
                                       stride=4 if i == 0 else 2)
            elif i == 3:
                f = conv(f, sd, "head.resize_layers.3", dtype, stride=2, padding=1)
            out.append(f)
        return out

    parts = [encode(slice(i, i + block)) for i in range(0, t_len, block)]
    l1, l2, l3, l4 = (torch.cat([p[i] for p in parts]) for i in range(4))
    del parts
    mm = "head.motion_modules.{}.temporal_transformer"
    l3 = temporal_module(sd, mm.format(0), l3, t_len, arch, dtype)
    l4 = temporal_module(sd, mm.format(1), l4, t_len, arch, dtype)
    sc = "head.scratch."
    r1, r2, r3, r4 = (conv(z, sd, f"{sc}layer{i + 1}_rn", dtype, bias=False, padding=1)
                      for i, z in enumerate((l1, l2, l3, l4)))
    path = fusion(sd, 4, r4, None, r3.shape[2:], dtype)
    path = temporal_module(sd, mm.format(2), path, t_len, arch, dtype)
    path = fusion(sd, 3, path, r3, r2.shape[2:], dtype)
    path = temporal_module(sd, mm.format(3), path, t_len, arch, dtype)

    def tail(sl):
        p = fusion(sd, 2, path[sl], r2[sl], r1.shape[2:], dtype)
        p = fusion(sd, 1, p, r1[sl], None, dtype)
        out = conv(p, sd, f"{sc}output_conv1", dtype, padding=1)
        out = resize(out, size=(gh * arch.patch_size, gw * arch.patch_size)).float()
        out = F.relu(conv(out, sd, f"{sc}output_conv2.0", torch.float32, padding=1))
        out = F.relu(conv(out, sd, f"{sc}output_conv2.2", torch.float32))
        out = F.relu(resize(out, size=(h, w)))                 # VideoDepthAnything.forward
        return resize(out, size=(fh, fw))[:, 0]                # infer_video_depth, per frame

    return in_blocks(tail, t_len, block)


# ---------------------------------------------------------------------------
# infer_video_depth's stitching, on the host


def stitch(windows: list[np.ndarray], arch: Arch) -> list[np.ndarray]:
    """The stitched stream from each window's raw (T, H, W) output, as
    ``infer_video_depth``'s second loop computes it (fp32 numpy): the first
    window as it is; each later one aligned by least squares on its first
    ``overlap - interp_len`` frames against the stitched keyframes, clamped
    at 0, and blended linearly into the last ``interp_len`` stitched frames."""
    il, align = arch.interp_len, arch.overlap - arch.interp_len
    kf = arch.keyframes[:align]
    out: list = []
    ref: list = []
    for raw in windows:
        raw = [np.asarray(f, np.float32) for f in raw]
        if not out:
            out += raw
            ref = [raw[k] for k in kf]
            continue
        pred = np.concatenate(raw[:align]).astype(np.float32)
        target = np.concatenate(ref).astype(np.float32)
        a00, a01, a11 = np.sum(pred * pred), np.sum(pred), np.float32(pred.size)
        b0, b1 = np.sum(pred * target), np.sum(target)
        det = a00 * a11 - a01 * a01
        scale, shift = (1.0, 0.0) if det == 0 else ((a11 * b0 - a01 * b1) / det,
                                                    (-a01 * b0 + a00 * b1) / det)
        post = [np.maximum(f * scale + shift, 0) for f in raw[align:arch.overlap]]
        wts = [0.0] + [i / (il - 1) for i in range(1, il - 1)] + [1.0]
        out[-il:] = [p * (1 - a) + q * a for p, q, a in zip(out[-il:], post, wts)]
        out += [np.maximum(f * scale + shift, 0) for f in raw[arch.overlap:]]
        ref = ref[:1] + [np.maximum(raw[k] * scale + shift, 0) for k in kf[1:]]
    return out
