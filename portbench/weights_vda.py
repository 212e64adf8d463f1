"""Video Depth Anything weights from a seed, in upstream's module layout.

Every tensor of ``VideoDepthAnything``'s state dict (``pretrained.*``, the
DINOv2 ViT; ``head.*``, the DPT head and its ``motion_modules``), made on the
device from one ``torch.Generator``. Weights are normal over the square root
of their fan-in, with heavy tails as ``portbench/weights.py`` draws Depth
Pro's: a share ``OUTLIER_SHARE`` of each weight tensor is ``OUTLIER_SCALE``
times larger (the tensor rescaled to unit variance), which a per-channel int8
code feels and bf16 rounding does not. Biases are zero, norm gains one, the
class and mask tokens and the position table 0.02 normal, the temporal
position buffers upstream's sinusoids.

Choices that make every layer reach the output, so that a fault in any of
them shows in the comparison that decides ``correct``:

- LayerScale is ``LAYER_SCALE`` (the ViT's blocks otherwise hardly move the
  residual stream at random weights, as in ``portbench/weights.py``);
- every temporal module's ``proj_out`` is drawn like any weight (upstream
  zero-initialises it for training, which would make the modules the
  identity);
- ``output_conv2``'s two biases are ``HEAD_BIASES``, so that most of the
  inverse depth lies above the two ReLUs.
"""

from __future__ import annotations

import math

import torch

from .reference.video_depth_anything import Arch

LAYER_SCALE = 0.3
HEAD_BIASES = (0.1, 0.5)  # output_conv2.0, output_conv2.2
OUTLIER_SHARE = 1e-3
OUTLIER_SCALE = 20.0


def layout(arch: Arch) -> dict:
    """name -> (shape, kind): "w" a weight (fan-in: the product of the
    shape past its first axis), "wt" a stride-k transposed conv's weight
    (fan-in: its input channels), "b" a bias, "g" a norm's gain, "ls"
    LayerScale, "tok" a token or the position table, "pe" a sinusoid
    buffer."""
    d, f, oc, p = arch.embed_dim, arch.features, arch.out_channels, arch.patch_size
    g = arch.pretrain_size // p
    out = {"pretrained.cls_token": ((1, 1, d), "tok"),
           "pretrained.pos_embed": ((1, g * g + 1, d), "tok"),
           "pretrained.mask_token": ((1, d), "tok"),
           "pretrained.patch_embed.proj.weight": ((d, 3, p, p), "w"),
           "pretrained.patch_embed.proj.bias": ((d,), "b"),
           "pretrained.norm.weight": ((d,), "g"), "pretrained.norm.bias": ((d,), "b")}

    def lin(key, o, i, kind="w", bias=True):
        out[f"{key}.weight"] = ((o, i), kind)
        if bias:
            out[f"{key}.bias"] = ((o,), "b")

    def norm(key, c):
        out[f"{key}.weight"] = ((c,), "g")
        out[f"{key}.bias"] = ((c,), "b")

    def conv(key, o, i, k, bias=True, kind="w"):
        out[f"{key}.weight"] = ((o, i, k, k) if kind == "w" else (i, o, k, k), kind)
        if bias:
            out[f"{key}.bias"] = ((o,), "b")

    hid = arch.mlp_ratio * d
    for i in range(arch.depth):
        b = f"pretrained.blocks.{i}."
        norm(b + "norm1", d)
        lin(b + "attn.qkv", 3 * d, d)
        lin(b + "attn.proj", d, d)
        out[b + "ls1.gamma"] = ((d,), "ls")
        norm(b + "norm2", d)
        lin(b + "mlp.fc1", hid, d)
        lin(b + "mlp.fc2", d, hid)
        out[b + "ls2.gamma"] = ((d,), "ls")
    for i in range(4):
        conv(f"head.projects.{i}", oc[i], d, 1)
    conv("head.resize_layers.0", oc[0], oc[0], 4, kind="wt")
    conv("head.resize_layers.1", oc[1], oc[1], 2, kind="wt")
    conv("head.resize_layers.3", oc[3], oc[3], 3)
    sc = "head.scratch."
    for i in range(4):
        conv(f"{sc}layer{i + 1}_rn", f, oc[i], 3, bias=False)
        for u in (1, 2):
            for c in (1, 2):
                conv(f"{sc}refinenet{i + 1}.resConfUnit{u}.conv{c}", f, f, 3)
        conv(f"{sc}refinenet{i + 1}.out_conv", f, f, 1)
    conv(f"{sc}output_conv1", f // 2, f, 3)
    conv(f"{sc}output_conv2.0", arch.head_features_2, f // 2, 3)
    conv(f"{sc}output_conv2.2", 1, arch.head_features_2, 1)
    for i, c in enumerate((oc[2], oc[3], f, f)):
        key = f"head.motion_modules.{i}.temporal_transformer"
        blk = f"{key}.transformer_blocks.0"
        norm(f"{key}.norm", c)
        lin(f"{key}.proj_in", c, c)
        for j in range(2):
            a = f"{blk}.attention_blocks.{j}"
            norm(f"{blk}.norms.{j}", c)
            for m in "qkv":
                lin(f"{a}.to_{m}", c, c, bias=False)
            lin(f"{a}.to_out.0", c, c)
            out[f"{a}.pos_encoder.pe"] = ((1, arch.temporal_max_len, c), "pe")
        norm(f"{blk}.ff_norm", c)
        lin(f"{blk}.ff.net.0.proj", 8 * c, c)
        lin(f"{blk}.ff.net.2", c, 4 * c)
        lin(f"{key}.proj_out", c, c)
    return out


def _sinusoid(length: int, dim: int) -> torch.Tensor:
    position = torch.arange(length).unsqueeze(1)
    div_term = torch.exp(torch.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = torch.zeros(1, length, dim)
    pe[0, :, 0::2] = torch.sin(position * div_term)
    pe[0, :, 1::2] = torch.cos(position * div_term)
    return pe


def make_weights(arch: Arch, seed: int, device) -> dict:
    """The state dict for ``seed`` on ``device`` (fp32)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63 ^ 0x0DA)
    unit = (1.0 + OUTLIER_SHARE * (OUTLIER_SCALE ** 2 - 1.0)) ** -0.5
    sd = {}
    for name, (shape, kind) in layout(arch).items():
        if kind in ("w", "wt"):
            fan = shape[0] if kind == "wt" else math.prod(shape[1:])
            t = torch.randn(shape, generator=gen, device=device)
            big = torch.rand(shape, generator=gen, device=device) < OUTLIER_SHARE
            t = torch.where(big, t * OUTLIER_SCALE, t) * (unit * fan ** -0.5)
        elif kind == "tok":
            t = torch.randn(shape, generator=gen, device=device) * 0.02
        elif kind == "pe":
            t = _sinusoid(shape[1], shape[2]).to(device)
        else:
            t = torch.full(shape, {"b": 0.0, "g": 1.0, "ls": LAYER_SCALE}[kind], device=device)
        sd[name] = t
    sc = "head.scratch.output_conv2"
    sd[f"{sc}.0.bias"].fill_(HEAD_BIASES[0])
    sd[f"{sc}.2.bias"].fill_(HEAD_BIASES[1])
    return sd
