"""Depth Pro weights from a seed, made on the device in two calls.

The tree has the layout the program's param trees have (the JAX-era layout:
NHWC/HWIO convolutions, ``(Cin, 4*Cout)`` matmul-form 2x2 deconvs,
head-contiguous packed qkv, ViT block leaves stacked ``(depth, ...)``), and
every random leaf is a view of ONE draw from a ``torch.Generator`` on the
device, scaled by fan-in as Depth Pro's own init does. Biases are zero,
LayerNorm gains one.

The draw is normal with heavy tails: a share ``OUTLIER_SHARE`` of the weights
is ``OUTLIER_SCALE`` times larger (the whole draw rescaled to unit variance),
as trained transformer weights have outliers. Rounding to bf16 does not care
(its error is relative to each weight), but a per-channel int8 code does (its
step is the channel's largest weight over 127), so the comparison that decides
``correct`` tells the configuration's bf16 from the next precision below.

Three more choices make every layer reach the depth map, so that a fault in
any of them shows in that comparison (``portbench/correct.py``):

- LayerScale ``ls1``/``ls2`` is ``LAYER_SCALE`` (the published init of 1e-5
  would leave each block's update below bf16's resolution of the residual
  stream, so the ViTs would compute the identity);
- the depth head's last bias is ``HEAD_BIAS``, so the canonical inverse depth
  is mostly above the head's ReLU;
- the FOV head's last bias is ``FOV_BIAS_DEG``, so the field of view, and
  with it f_px and the depth's scale, is a plausible camera's.
"""

from __future__ import annotations

import torch

from .reference.depth_pro import Arch

LAYER_SCALE = 0.3
HEAD_BIAS = 0.5
FOV_BIAS_DEG = 60.0
OUTLIER_SHARE = 1e-3  # share of the drawn weights that are outliers
OUTLIER_SCALE = 20.0  # how many times larger an outlier is
_ALIGN = 64  # elements: every leaf starts 256-byte aligned in the draw


def _spec(arch: Arch) -> dict:
    """The tree as (shape, kind, value): kind "n" draws normal * value, "c"
    fills value; ``None`` stays None."""
    d, l, df = arch.embed_dim, arch.depth, arch.decoder_features
    dims = arch.dims_encoder
    p3 = arch.patch_size ** 2 * 3
    hid = arch.mlp_ratio * d

    def n(shape, scale):
        return (tuple(shape), "n", scale)

    def c(shape, value):
        return (tuple(shape), "c", float(value))

    def conv(kh, kw, i, o):
        return n((kh, kw, i, o), (kh * kw * i) ** -0.5)

    def dec(i, o):
        return n((i, 4 * o), (4 * i) ** -0.5)

    def vit():
        return {
            "patch_embed": {"w": n((p3, d), p3 ** -0.5), "b": c((d,), 0)},
            "cls_token": n((1, 1, d), 0.02),
            "pos_embed": n((1, arch.tokens, d), 0.02),
            "blocks": {
                "ln1_g": c((l, d), 1), "ln1_b": c((l, d), 0),
                "qkv_w": n((l, d, 3 * d), d ** -0.5), "qkv_b": c((l, 3 * d), 0),
                "proj_w": n((l, d, d), d ** -0.5), "proj_b": c((l, d), 0),
                "ls1": c((l, d), LAYER_SCALE),
                "ln2_g": c((l, d), 1), "ln2_b": c((l, d), 0),
                "fc1_w": n((l, d, hid), d ** -0.5), "fc1_b": c((l, hid), 0),
                "fc2_w": n((l, hid, d), hid ** -0.5), "fc2_b": c((l, d), 0),
                "ls2": c((l, d), LAYER_SCALE),
            },
            "norm": {"g": c((d,), 1), "b": c((d,), 0)},
        }

    def up(i, o, k, mid=None):
        mid = mid or o
        return {"proj_w": conv(1, 1, i, mid),
                "deconvs": [dec(mid if j == 0 else o, o) for j in range(k)]}

    def res():
        return {"w1": conv(3, 3, df, df), "b1": c((df,), 0),
                "w2": conv(3, 3, df, df), "b2": c((df,), 0)}

    dec_dims = (df,) + tuple(dims)
    k = max(arch.grid // 4, 1)
    return {
        "encoder": {
            "patch_vit": vit(), "image_vit": vit(),
            "upsample_latent0": up(d, df, 3, mid=dims[0]),
            "upsample_latent1": up(d, dims[0], 2),
            "upsample0": up(d, dims[1], 1), "upsample1": up(d, dims[2], 1),
            "upsample2": up(d, dims[3], 1),
            "upsample_lowres": {"w": dec(d, dims[3]), "b": c((dims[3],), 0)},
            "fuse_lowres": {"w": conv(1, 1, 2 * dims[3], dims[3]), "b": c((dims[3],), 0)},
        },
        "decoder": {
            "convs": [None] + [conv(3, 3, dim, df) for dim in dec_dims[1:]],
            "fusions": [{"res1": res(), "res2": res(),
                         "deconv_w": dec(df, df) if i else None,
                         "out": {"w": conv(1, 1, df, df), "b": c((df,), 0)}}
                        for i in range(len(dec_dims))],
        },
        "head": {
            "conv_in": {"w": conv(3, 3, df, df // 2), "b": c((df // 2,), 0)},
            "deconv": {"w": dec(df // 2, df // 2), "b": c((df // 2,), 0)},
            "conv_mid": {"w": conv(3, 3, df // 2, 32), "b": c((32,), 0)},
            "conv_out": {"w": conv(1, 1, 32, 1), "b": c((1,), HEAD_BIAS)},
        },
        "fov": {
            "vit": vit(),
            "proj": {"w": n((d, df // 2), d ** -0.5), "b": c((df // 2,), 0)},
            "down": {"w": conv(3, 3, df, df // 2), "b": c((df // 2,), 0)},
            "head": [{"w": conv(3, 3, df // 2, df // 4), "b": c((df // 4,), 0)},
                     {"w": conv(3, 3, df // 4, df // 8), "b": c((df // 8,), 0)},
                     {"w": conv(k, k, df // 8, 1), "b": c((1,), FOV_BIAS_DEG)}],
        },
    }


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    elif node is not None:
        yield node


def _padded(numel: int) -> int:
    return -(-numel // _ALIGN) * _ALIGN


def make_weights(arch: Arch, seed: int, device) -> dict:
    """The fp32 tree for ``seed`` on ``device``: one draw for every random
    leaf (each a view of it), fills for the rest."""
    spec = _spec(arch)
    draws = [leaf for leaf in _leaves(spec) if leaf[1] == "n"]
    sizes = [_padded(int(torch.Size(shape).numel())) for shape, _, _ in draws]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    if OUTLIER_SHARE > 0:
        wide = torch.rand(flat.numel(), generator=gen, device=device) < OUTLIER_SHARE
        flat = torch.where(wide, flat * OUTLIER_SCALE, flat)
        flat /= (1.0 + OUTLIER_SHARE * (OUTLIER_SCALE ** 2 - 1.0)) ** 0.5
    offsets = {}
    at = 0
    for leaf, size in zip(draws, sizes):
        offsets[id(leaf)] = at
        at += size

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        if node is None:
            return None
        shape, kind, value = node
        if kind == "c":
            return torch.full(shape, value, device=device)
        numel = int(torch.Size(shape).numel())
        start = offsets[id(node)]
        return flat[start:start + numel].view(shape).mul_(value)

    return build(spec)
