"""Reference ``depth_pro.pt`` state dict -> the port's param tree.

Twin of ``ml_depth_pro_video_tpu/ckpt/convert.py``: the same numpy
conversion (float64 where the JAX package resamples in float64), so one
converted tree serves both packages. Layouts:

- conv:            (O, I, kh, kw)   -> (kh, kw, I, O)          [HWIO]
- conv-transpose:  (I, O, 2, 2)     -> (I, 2*2*O)              [matmul form]
- linear:          (O, I)           -> (I, O)
- patch embed:     (D, 3, P, P)     -> (P*P*3, D)              [patchify-matmul]
- ViT blocks:      per-block tensors stacked along a leading depth axis,
                   qkv columns packed head-contiguous

The timm resampling that the reference runs at model build time
(patch-embed kernel 14 -> 16 with a magnitude rescale, pos-embed 518 ->
384) is baked in here through ``ops/resize.py::resize_matrix``. The
conversion is strict: a key that it does not consume raises
(``_TrackedSD``), except timm's unused ``fc_norm`` keys, as the reference
exempts them. ``save_params`` writes the flat npz that
``ckpt/params.py::load_params`` (and the JAX package's) reads.

Command line: ``depth-pro-convert-torch depth_pro.pt depth_pro_tpu.npz``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.vit import ViTConfig
from ..ops.resize import resize_matrix


def _np(t) -> np.ndarray:
    """torch tensor or array-like -> fp32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _conv(sd, key, bias=True):
    out = {"w": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    if bias:
        out["b"] = _np(sd[f"{key}.bias"])
    return out


def _deconv2x2_w(sd, key) -> np.ndarray:
    w = _np(sd[f"{key}.weight"])  # (I, O, 2, 2)
    cin, cout = w.shape[0], w.shape[1]
    return w.transpose(0, 2, 3, 1).reshape(cin, 4 * cout)


def _linear(sd, key):
    return {"w": _np(sd[f"{key}.weight"]).T, "b": _np(sd[f"{key}.bias"])}


# ---------------------------------------------------------------------------
# ViT


_BLOCK_KEYS = {  # tree key -> (timm key, transpose, pack per head)
    "ln1_g": ("norm1.weight", False, False), "ln1_b": ("norm1.bias", False, False),
    "qkv_w": ("attn.qkv.weight", True, True), "qkv_b": ("attn.qkv.bias", False, True),
    "proj_w": ("attn.proj.weight", True, False), "proj_b": ("attn.proj.bias", False, False),
    "ls1": ("ls1.gamma", False, False),
    "ln2_g": ("norm2.weight", False, False), "ln2_b": ("norm2.bias", False, False),
    "fc1_w": ("mlp.fc1.weight", True, False), "fc1_b": ("mlp.fc1.bias", False, False),
    "fc2_w": ("mlp.fc2.weight", True, False), "fc2_b": ("mlp.fc2.bias", False, False),
    "ls2": ("ls2.gamma", False, False),
}


def convert_vit(sd: dict, prefix: str, cfg: ViTConfig) -> dict:
    """Convert a timm-style ViT state dict subtree at ``prefix``."""

    def g(key):
        return _np(sd[prefix + key])

    d, nh = cfg.embed_dim, cfg.num_heads
    hd = d // nh

    def pack_per_head(w_t):
        """torch [q|k|v] column order -> head-contiguous [h0:(q,k,v) | h1:(q,k,v) | ...]."""
        lead = w_t.shape[:-1]
        return np.moveaxis(w_t.reshape(*lead, 3, nh, hd), -3, -2).reshape(*lead, 3 * d)

    blocks = {}
    for name, (key, transpose, packed) in _BLOCK_KEYS.items():
        per_block = []
        for i in range(cfg.depth):
            w = g(f"blocks.{i}.{key}")
            w = w.T if transpose else w
            per_block.append(pack_per_head(w) if packed else w)
        blocks[name] = np.stack(per_block)

    pw = g("patch_embed.proj.weight")  # (D, 3, P, P)
    pos = g("pos_embed")
    if pw.shape[-1] != cfg.patch_size:
        pw = resample_patch_embed(pw, cfg.patch_size)
    if int(round((pos.shape[1] - 1) ** 0.5)) != cfg.grid_size:
        pos = resample_pos_embed(pos, cfg.grid_size)
    return {
        "patch_embed": {"w": pw.transpose(2, 3, 1, 0).reshape(-1, d),
                        "b": g("patch_embed.proj.bias")},
        "cls_token": g("cls_token"),
        "pos_embed": pos,
        "blocks": blocks,
        "norm": {"g": g("norm.weight"), "b": g("norm.bias")},
    }


def resample_patch_embed(w: np.ndarray, new_patch: int) -> np.ndarray:
    """Bicubic-resample a (D, C, p, p) patch-embed kernel to ``new_patch``,
    with the reference's magnitude rescale (h/nh)*(w/nw)."""
    _, _, h, wd = w.shape
    mh = resize_matrix(h, new_patch, "bicubic", antialias=False).astype(np.float64)
    mw = resize_matrix(wd, new_patch, "bicubic", antialias=False).astype(np.float64)
    out = np.einsum("oh,dchw,pw->dcop", mh, w.astype(np.float64), mw)
    return (out * (h / new_patch) * (wd / new_patch)).astype(np.float32)


def resample_pos_embed(pos: np.ndarray, new_grid: int, num_prefix: int = 1) -> np.ndarray:
    """Anti-aliased bicubic pos-embed resample (timm's ``resample_abs_pos_embed``)."""
    prefix, grid = pos[:, :num_prefix], pos[:, num_prefix:]
    g = int(round(grid.shape[1] ** 0.5))
    d = grid.shape[-1]
    grid = grid.reshape(1, g, g, d).astype(np.float64)
    mh = resize_matrix(g, new_grid, "bicubic", antialias=True).astype(np.float64)
    out = np.einsum("oh,bhwd->bowd", mh, grid)
    out = np.einsum("ow,bhwd->bhod", mh, out)
    out = out.reshape(1, new_grid * new_grid, d).astype(np.float32)
    return np.concatenate([prefix, out], axis=1)


# ---------------------------------------------------------------------------
# DepthPro


def _upsample_block(sd, prefix: str, n_deconv: int) -> dict:
    """Pyramid block: a 1x1 projection conv (no bias), then ``n_deconv`` 2x2/s2 deconvs."""
    return {
        "proj_w": _np(sd[f"{prefix}.0.weight"]).transpose(2, 3, 1, 0),
        "deconvs": [_deconv2x2_w(sd, f"{prefix}.{1 + i}") for i in range(n_deconv)],
    }


def _fusion(sd, prefix: str, deconv: bool) -> dict:
    def res(name):
        return {
            "w1": _np(sd[f"{prefix}.{name}.residual.1.weight"]).transpose(2, 3, 1, 0),
            "b1": _np(sd[f"{prefix}.{name}.residual.1.bias"]),
            "w2": _np(sd[f"{prefix}.{name}.residual.3.weight"]).transpose(2, 3, 1, 0),
            "b2": _np(sd[f"{prefix}.{name}.residual.3.bias"]),
        }

    return {
        "res1": res("resnet1"),
        "res2": res("resnet2"),
        "out": _conv(sd, f"{prefix}.out_conv"),
        "deconv_w": _deconv2x2_w(sd, f"{prefix}.deconv") if deconv else None,
    }


class _TrackedSD:
    """State-dict view that records every consumed key, so that the
    conversion fails on leftovers (the reference loads strictly): dropping
    an unconsumed tensor would turn a mismatched checkpoint into a wrong but
    running model."""

    def __init__(self, sd: dict):
        self.sd = sd
        self.used: set = set()

    def __getitem__(self, key):
        self.used.add(key)
        return self.sd[key]

    def leftovers(self) -> list:
        # the reference exempts timm's unused fc_norm keys
        return sorted(k for k in set(self.sd) - self.used if "fc_norm" not in k)


def convert_depth_pro(sd: dict, cfg) -> dict:
    """Convert the full reference DepthPro state dict for ``cfg`` (a
    ``models/depth_pro.py::DepthProConfig``). Raises on unconsumed keys."""
    sd = _TrackedSD(sd)
    vit_cfg = cfg.vit
    enc = {
        "patch_vit": convert_vit(sd, "encoder.patch_encoder.", vit_cfg),
        "image_vit": convert_vit(sd, "encoder.image_encoder.", vit_cfg),
        "upsample_latent0": _upsample_block(sd, "encoder.upsample_latent0", 3),
        "upsample_latent1": _upsample_block(sd, "encoder.upsample_latent1", 2),
        "upsample0": _upsample_block(sd, "encoder.upsample0", 1),
        "upsample1": _upsample_block(sd, "encoder.upsample1", 1),
        "upsample2": _upsample_block(sd, "encoder.upsample2", 1),
        "upsample_lowres": {"w": _deconv2x2_w(sd, "encoder.upsample_lowres"),
                            "b": _np(sd["encoder.upsample_lowres.bias"])},
        "fuse_lowres": _conv(sd, "encoder.fuse_lowres"),
    }
    n_levels = 5
    dec = {
        "convs": [None] + [_np(sd[f"decoder.convs.{i}.weight"]).transpose(2, 3, 1, 0)
                           for i in range(1, n_levels)],
        "fusions": [_fusion(sd, f"decoder.fusions.{i}", deconv=(i != 0))
                    for i in range(n_levels)],
    }
    head = {
        "conv_in": _conv(sd, "head.0"),
        "deconv": {"w": _deconv2x2_w(sd, "head.1"), "b": _np(sd["head.1.bias"])},
        "conv_mid": _conv(sd, "head.2"),
        "conv_out": _conv(sd, "head.4"),
    }
    params = {"encoder": enc, "decoder": dec, "head": head}
    if cfg.use_fov_head:
        params["fov"] = {
            "vit": convert_vit(sd, "fov.encoder.0.", vit_cfg),
            "proj": _linear(sd, "fov.encoder.1"),
            "down": _conv(sd, "fov.downsample.0"),
            "head": [_conv(sd, f"fov.head.{i}") for i in (0, 2, 4)],
        }
    extra = sd.leftovers()
    if extra:
        raise ValueError(
            f"{len(extra)} checkpoint keys were not consumed by the conversion "
            f"(wrong or mismatched checkpoint?): {extra[:8]}{'...' if len(extra) > 8 else ''}")
    return params


# ---------------------------------------------------------------------------
# flat npz serialization (read back by ckpt/params.py::load_params)


def _flatten(tree, prefix: str = "", out: dict | None = None) -> dict:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif tree is None:
        out[prefix[:-1] + "#none"] = np.zeros((), np.float32)
    else:
        out[prefix[:-1]] = np.asarray(tree.detach().cpu() if hasattr(tree, "detach") else tree)
    return out


def save_params(path: str, params) -> None:
    """Write a param tree (numpy or torch leaves) as a flat npz (keys ``a/b/0/c``)."""
    np.savez(path, **_flatten(params))


def convert_checkpoint(torch_ckpt_path: str, out_path: str, cfg=None) -> None:
    """``depth_pro.pt`` -> flat npz of the converted tree."""
    import torch

    from ..models.depth_pro import DEFAULT_MONODEPTH_CONFIG

    sd = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    save_params(out_path, convert_depth_pro(sd, cfg or DEFAULT_MONODEPTH_CONFIG))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a reference depth_pro.pt to the flat npz "
                                             "param tree that the PyTorch port loads")
    ap.add_argument("torch_ckpt")
    ap.add_argument("out_npz")
    args = ap.parse_args(argv)
    convert_checkpoint(args.torch_ckpt, args.out_npz)


if __name__ == "__main__":  # pragma: no cover
    main()
