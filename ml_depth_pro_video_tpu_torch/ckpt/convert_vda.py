"""Upstream Video Depth Anything state dict -> the port's param tree.

The route a real checkpoint takes (``video_depth_anything_vitl.pth``, the
module layout of ``github.com/DepthAnything/Video-Depth-Anything``:
``pretrained.*`` the DINOv2 ViT, ``head.*`` the DPT head with its
``motion_modules``). Layouts, as ``ckpt/convert.py``'s:

- conv:            (O, I, kh, kw)   -> (kh, kw, I, O)          [HWIO]
- conv-transpose:  (I, O, k, k)     -> (I, k*k*O)              [matmul form]
- linear:          (O, I)           -> (I, O)
- patch embed:     (D, 3, P, P)     -> (P*P*3, D)              [patchify-matmul]
- ViT blocks:      stacked along a leading depth axis, qkv columns packed
                   head-contiguous;
- temporal attention: ``to_q``, ``to_k``, ``to_v`` (no bias) packed into one
                   (C, 3C) head-contiguous weight at the module's heads.

The tensors stay torch tensors on the state dict's device. The conversion is
strict: a key it does not consume raises, except the two that upstream's
inference never reads (``pretrained.mask_token``, and ``refinenet4``'s first
residual unit, which has no skip input to run on).
"""

from __future__ import annotations

import math

import torch

from ..models.video_depth_anything import VDAConfig
from .convert import _TrackedSD

_UNREAD = ("pretrained.mask_token", "head.scratch.refinenet4.resConfUnit1.")


def _pack_per_head(w: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., 3*D) columns [q | k | v] -> head-contiguous [h0:(q,k,v) | h1:(q,k,v) | ...]."""
    lead, d3 = w.shape[:-1], w.shape[-1]
    d = d3 // 3
    return w.reshape(*lead, 3, heads, d // heads).movedim(-3, -2).reshape(*lead, d3)


def convert_video_depth_anything(sd: dict, cfg: VDAConfig) -> dict:
    """Convert an upstream ``VideoDepthAnything`` state dict for ``cfg``.
    Raises on unconsumed keys."""
    tracked = _TrackedSD(sd)

    def g(key):
        return tracked[key].float()

    def conv(key, bias=True):
        out = {"w": g(f"{key}.weight").permute(2, 3, 1, 0).contiguous()}
        if bias:
            out["b"] = g(f"{key}.bias")
        return out

    def linear(key):
        return {"w": g(f"{key}.weight").T.contiguous(), "b": g(f"{key}.bias")}

    def deconv(key):
        w = g(f"{key}.weight")  # (I, O, k, k)
        return {"w": w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous(),
                "b": g(f"{key}.bias")}

    v, d = cfg.vit, cfg.vit.embed_dim
    pre = "pretrained."

    def stack(key, transpose=False, packed=False):
        per = []
        for i in range(v.depth):
            w = g(f"{pre}blocks.{i}.{key}")
            w = w.T if transpose else w
            per.append(_pack_per_head(w, v.num_heads) if packed else w)
        return torch.stack(per).contiguous()

    pw = g(f"{pre}patch_embed.proj.weight")  # (D, 3, P, P)
    vit = {
        "patch_embed": {"w": pw.permute(2, 3, 1, 0).reshape(-1, d).contiguous(),
                        "b": g(f"{pre}patch_embed.proj.bias")},
        "cls_token": g(f"{pre}cls_token"),
        "pos_embed": g(f"{pre}pos_embed"),
        "blocks": {
            "ln1_g": stack("norm1.weight"), "ln1_b": stack("norm1.bias"),
            "qkv_w": stack("attn.qkv.weight", True, True),
            "qkv_b": stack("attn.qkv.bias", False, True),
            "proj_w": stack("attn.proj.weight", True), "proj_b": stack("attn.proj.bias"),
            "ls1": stack("ls1.gamma"),
            "ln2_g": stack("norm2.weight"), "ln2_b": stack("norm2.bias"),
            "fc1_w": stack("mlp.fc1.weight", True), "fc1_b": stack("mlp.fc1.bias"),
            "fc2_w": stack("mlp.fc2.weight", True), "fc2_b": stack("mlp.fc2.bias"),
            "ls2": stack("ls2.gamma"),
        },
        "norm": {"g": g(f"{pre}norm.weight"), "b": g(f"{pre}norm.bias")},
    }
    if vit["pos_embed"].shape[1] != v.num_tokens:
        raise ValueError(f"the checkpoint's position table has {vit['pos_embed'].shape[1]} rows; "
                         f"the config's {v.img_size}/{v.patch_size} grid has {v.num_tokens}")

    h = "head."
    sc = f"{h}scratch."

    def unit(key):
        return {"w1": g(f"{key}.conv1.weight").permute(2, 3, 1, 0).contiguous(),
                "b1": g(f"{key}.conv1.bias"),
                "w2": g(f"{key}.conv2.weight").permute(2, 3, 1, 0).contiguous(),
                "b2": g(f"{key}.conv2.bias")}

    def fusion(i):
        key = f"{sc}refinenet{i + 1}"
        return {"res1": None if i == 3 else unit(f"{key}.resConfUnit1"),
                "res2": unit(f"{key}.resConfUnit2"), "out": conv(f"{key}.out_conv")}

    def temporal(i):
        key = f"{h}motion_modules.{i}.temporal_transformer"
        blk = f"{key}.transformer_blocks.0"
        attn = []
        for j in range(2):
            a = f"{blk}.attention_blocks.{j}"
            qkv = torch.cat([g(f"{a}.to_{n}.weight").T for n in "qkv"], dim=1)
            attn.append({"ln_g": g(f"{blk}.norms.{j}.weight"), "ln_b": g(f"{blk}.norms.{j}.bias"),
                         "qkv_w": _pack_per_head(qkv, cfg.temporal_heads).contiguous(),
                         "out_w": g(f"{a}.to_out.0.weight").T.contiguous(),
                         "out_b": g(f"{a}.to_out.0.bias")})
        pe, pe1 = (g(f"{blk}.attention_blocks.{j}.pos_encoder.pe")[0] for j in range(2))
        if not torch.equal(pe, pe1):
            raise ValueError(f"{key}: the two attentions' position tables differ")
        return {"gn_g": g(f"{key}.norm.weight"), "gn_b": g(f"{key}.norm.bias"),
                "proj_in": linear(f"{key}.proj_in"), "attn": attn,
                "ff_ln_g": g(f"{blk}.ff_norm.weight"), "ff_ln_b": g(f"{blk}.ff_norm.bias"),
                "ff1": linear(f"{blk}.ff.net.0.proj"), "ff2": linear(f"{blk}.ff.net.2"),
                "proj_out": linear(f"{key}.proj_out"), "pe": pe.contiguous()}

    head = {
        "projects": [conv(f"{h}projects.{i}") for i in range(4)],
        "resize": [deconv(f"{h}resize_layers.0"), deconv(f"{h}resize_layers.1"), None,
                   conv(f"{h}resize_layers.3")],
        "rn": [conv(f"{sc}layer{i + 1}_rn", bias=False)["w"] for i in range(4)],
        "fusions": [fusion(i) for i in range(4)],
        "out1": conv(f"{sc}output_conv1"),
        "out2a": conv(f"{sc}output_conv2.0"),
        "out2b": conv(f"{sc}output_conv2.2"),
        "temporal": [temporal(i) for i in range(4)],
    }
    extra = [k for k in tracked.leftovers() if not k.startswith(_UNREAD)]
    if extra:
        raise ValueError(
            f"{len(extra)} checkpoint keys were not consumed by the conversion "
            f"(wrong or mismatched checkpoint?): {extra[:8]}{'...' if len(extra) > 8 else ''}")
    return {"vit": vit, "head": head}


def upstream_layout(cfg: VDAConfig) -> dict:
    """Every tensor of upstream's state dict for ``cfg``: name -> (shape,
    kind), kind one of "w" (a weight, fan-in = the product of its shape
    past the first axis), "wt" (a stride-k kxk transposed conv's weight,
    fan-in = its input channels, the first axis), "b"
    (a bias), "g" (a norm's gain), "ls" (LayerScale), "tok" (the class and
    mask tokens, the position table) and "pe" (the sinusoidal buffer)."""
    v, d, f = cfg.vit, cfg.vit.embed_dim, cfg.features
    oc, p = cfg.out_channels, cfg.vit.patch_size
    out = {"pretrained.cls_token": ((1, 1, d), "tok"),
           "pretrained.pos_embed": ((1, v.num_tokens, d), "tok"),
           "pretrained.mask_token": ((1, d), "tok"),
           "pretrained.patch_embed.proj.weight": ((d, 3, p, p), "w"),
           "pretrained.patch_embed.proj.bias": ((d,), "b"),
           "pretrained.norm.weight": ((d,), "g"), "pretrained.norm.bias": ((d,), "b")}
    hid = v.mlp_ratio * d
    for i in range(v.depth):
        b = f"pretrained.blocks.{i}."
        out.update({b + "norm1.weight": ((d,), "g"), b + "norm1.bias": ((d,), "b"),
                    b + "attn.qkv.weight": ((3 * d, d), "w"), b + "attn.qkv.bias": ((3 * d,), "b"),
                    b + "attn.proj.weight": ((d, d), "w"), b + "attn.proj.bias": ((d,), "b"),
                    b + "ls1.gamma": ((d,), "ls"),
                    b + "norm2.weight": ((d,), "g"), b + "norm2.bias": ((d,), "b"),
                    b + "mlp.fc1.weight": ((hid, d), "w"), b + "mlp.fc1.bias": ((hid,), "b"),
                    b + "mlp.fc2.weight": ((d, hid), "w"), b + "mlp.fc2.bias": ((d,), "b"),
                    b + "ls2.gamma": ((d,), "ls")})

    def conv(key, o, i, k, bias=True):
        out[f"{key}.weight"] = ((o, i, k, k), "w")
        if bias:
            out[f"{key}.bias"] = ((o,), "b")

    for i in range(4):
        conv(f"head.projects.{i}", oc[i], d, 1)
    out["head.resize_layers.0.weight"] = ((oc[0], oc[0], 4, 4), "wt")
    out["head.resize_layers.0.bias"] = ((oc[0],), "b")
    out["head.resize_layers.1.weight"] = ((oc[1], oc[1], 2, 2), "wt")
    out["head.resize_layers.1.bias"] = ((oc[1],), "b")
    conv("head.resize_layers.3", oc[3], oc[3], 3)
    sc = "head.scratch."
    for i in range(4):
        conv(f"{sc}layer{i + 1}_rn", f, oc[i], 3, bias=False)
        for u in (1, 2):
            for c in (1, 2):
                conv(f"{sc}refinenet{i + 1}.resConfUnit{u}.conv{c}", f, f, 3)
        conv(f"{sc}refinenet{i + 1}.out_conv", f, f, 1)
    conv(f"{sc}output_conv1", f // 2, f, 3)
    conv(f"{sc}output_conv2.0", cfg.head_features_2, f // 2, 3)
    conv(f"{sc}output_conv2.2", 1, cfg.head_features_2, 1)
    for i, c in enumerate((oc[2], oc[3], f, f)):
        key = f"head.motion_modules.{i}.temporal_transformer"
        blk = f"{key}.transformer_blocks.0"
        out.update({f"{key}.norm.weight": ((c,), "g"), f"{key}.norm.bias": ((c,), "b"),
                    f"{key}.proj_in.weight": ((c, c), "w"), f"{key}.proj_in.bias": ((c,), "b"),
                    f"{key}.proj_out.weight": ((c, c), "w"), f"{key}.proj_out.bias": ((c,), "b"),
                    f"{blk}.ff_norm.weight": ((c,), "g"), f"{blk}.ff_norm.bias": ((c,), "b"),
                    f"{blk}.ff.net.0.proj.weight": ((8 * c, c), "w"),
                    f"{blk}.ff.net.0.proj.bias": ((8 * c,), "b"),
                    f"{blk}.ff.net.2.weight": ((c, 4 * c), "w"),
                    f"{blk}.ff.net.2.bias": ((c,), "b")})
        for j in range(2):
            a = f"{blk}.attention_blocks.{j}"
            out.update({f"{blk}.norms.{j}.weight": ((c,), "g"),
                        f"{blk}.norms.{j}.bias": ((c,), "b"),
                        f"{a}.to_q.weight": ((c, c), "w"), f"{a}.to_k.weight": ((c, c), "w"),
                        f"{a}.to_v.weight": ((c, c), "w"),
                        f"{a}.to_out.0.weight": ((c, c), "w"), f"{a}.to_out.0.bias": ((c,), "b"),
                        f"{a}.pos_encoder.pe": ((1, cfg.temporal_max_len, c), "pe")})
    return out


def random_state_dict(cfg: VDAConfig, generator: torch.Generator, device="cpu",
                      layer_scale: float = 1.0) -> dict:
    """Random weights in upstream's layout: weights normal over the square
    root of their fan-in, biases zero, gains one, tokens 0.02 normal, the
    position buffers as upstream computes them. ``proj_out`` is drawn like
    every weight (upstream zero-initialises it for training), so that the
    temporal modules reach the output."""
    from ..models.video_depth_anything import sinusoid_table

    sd = {}
    for name, (shape, kind) in upstream_layout(cfg).items():
        if kind in ("w", "wt"):
            fan = shape[0] if kind == "wt" else math.prod(shape[1:])
            t = torch.randn(shape, generator=generator, device=device) * fan ** -0.5
        elif kind == "tok":
            t = torch.randn(shape, generator=generator, device=device) * 0.02
        elif kind == "pe":
            t = sinusoid_table(shape[1], shape[2])[None].to(device)
        else:
            value = {"b": 0.0, "g": 1.0, "ls": layer_scale}[kind]
            t = torch.full(shape, value, device=device)
        sd[name] = t
    return sd


def build_vda_params(cfg: VDAConfig, device, rng_seed: int = 0) -> dict:
    """The checkpoint's tree when it exists, else random weights from
    ``rng_seed`` (with a warning), on ``device``."""
    import logging

    params = load_vda_checkpoint(cfg, device)
    if params is None:
        if cfg.checkpoint_uri is not None:
            logging.getLogger(__name__).warning(
                "checkpoint %s not found; running with RANDOM weights (depth output will be "
                "garbage)", cfg.checkpoint_uri)
        gen = torch.Generator(device).manual_seed(rng_seed)
        params = convert_video_depth_anything(random_state_dict(cfg, gen, device), cfg)
    return params


def load_vda_checkpoint(cfg: VDAConfig, device="cpu") -> dict | None:
    """The converted tree of ``cfg.checkpoint_uri`` on ``device``, or None
    when there is no such file."""
    import os

    uri = cfg.checkpoint_uri
    if uri is None or not os.path.exists(uri):
        return None
    sd = torch.load(uri, map_location=device, weights_only=True)
    return convert_video_depth_anything(sd, cfg)
