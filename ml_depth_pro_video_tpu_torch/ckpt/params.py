"""The weights bridge: param trees for the PyTorch port.

A param tree is the JAX package's nested structure of dicts, lists and
``None`` (``ml_depth_pro_video_tpu/models/depth_pro.py::init_depth_pro``),
with the same key names and JAX layouts (NHWC/HWIO convs, matmul-form
2x2 deconvs ``(Cin, 4*Cout)``, head-contiguous packed qkv, ViT block
params stacked ``(L, ...)``); here the leaves are torch tensors.

- :func:`load_params` reads the flat npz of the JAX package's
  ``ckpt/convert.py::save_params`` (keys ``a/b/0/c``, ``#none`` markers)
  without importing jax;
- :func:`from_numpy_tree` turns a numpy tree into tensors on a device;
- :func:`init_depth_pro` builds a random tree directly on a device;
- :class:`ParamTree` holds a tree as an ``nn.Module``'s parameters.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .quantize import _QUANT_KEYS


def _unflatten(flat: dict):
    """Twin of ``ml_depth_pro_video_tpu/ckpt/convert.py::_unflatten``."""
    root: dict = {}
    for key, val in flat.items():
        none = key.endswith("#none")
        parts = (key[: -len("#none")] if none else key).split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if none else val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_params(npz_path: str) -> dict:
    """Flat npz (``save_params``) -> nested tree of numpy arrays."""
    with np.load(npz_path) as f:
        return _unflatten(dict(f))


def _is_quantized_code(path: tuple) -> bool:
    """Whether ``path`` names the int8 codes of a ViT block matmul weight,
    the one place ``ckpt/quantize.py`` puts int8 leaves."""
    vit = path[:2] in (("encoder", "patch_vit"), ("encoder", "image_vit"), ("fov", "vit"))
    return (vit and len(path) == 5 and path[2] == "blocks" and path[3] in _QUANT_KEYS
            and path[4] == "q")


def _map_with_path(fn, tree, path: tuple = ()):
    """Apply ``fn(path, leaf)`` to every leaf of a dict/list tree; ``path`` is
    the tuple of keys (list indices as strings); ``None`` stays None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list tree; ``None`` stays None."""
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


def from_numpy_tree(tree, device="cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Numpy param tree (as the JAX package builds or saves it) -> the same
    tree of torch tensors on ``device``, in ``dtype``. A quantized tree
    (``ckpt/quantize.py``) keeps its int8 codes as int8; an int8 leaf
    anywhere else is refused."""

    def leaf(path, a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            if not _is_quantized_code(path):
                raise ValueError(f"int8 leaf at /{'/'.join(path)}: only the codes of the ViT "
                                 f"block matmul weights ({', '.join(_QUANT_KEYS)}) are int8")
            return torch.tensor(a, device=device)
        return torch.tensor(a, dtype=dtype, device=device)

    return _map_with_path(leaf, tree)


def to_numpy_tree(tree) -> dict:
    return map_tree(lambda t: t.detach().cpu().numpy(), tree)


def init_vit(cfg, generator: torch.Generator, device) -> dict:
    """Random ViT params: the tree of ``models/vit.py::init_vit``, built on
    ``device`` with the same distributions (not the same numbers)."""
    d, l = cfg.embed_dim, cfg.depth
    p3 = cfg.patch_size * cfg.patch_size * 3
    hidden = cfg.mlp_ratio * d

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def const(shape, value):
        return torch.full(shape, float(value), device=device)

    return {
        "patch_embed": {"w": nrm((p3, d), p3**-0.5), "b": const((d,), 0)},
        "cls_token": nrm((1, 1, d), 0.02),
        "pos_embed": nrm((1, cfg.num_tokens, d), 0.02),
        "blocks": {
            "ln1_g": const((l, d), 1),
            "ln1_b": const((l, d), 0),
            "qkv_w": nrm((l, d, 3 * d), d**-0.5),
            "qkv_b": const((l, 3 * d), 0),
            "proj_w": nrm((l, d, d), d**-0.5),
            "proj_b": const((l, d), 0),
            "ls1": const((l, d), 1e-5),
            "ln2_g": const((l, d), 1),
            "ln2_b": const((l, d), 0),
            "fc1_w": nrm((l, d, hidden), d**-0.5),
            "fc1_b": const((l, hidden), 0),
            "fc2_w": nrm((l, hidden, d), hidden**-0.5),
            "fc2_b": const((l, d), 0),
            "ls2": const((l, d), 1e-5),
        },
        "norm": {"g": const((d,), 1), "b": const((d,), 0)},
    }


def init_depth_pro(cfg, generator: torch.Generator, device="cpu") -> dict:
    """Random Depth Pro params on ``device``: the tree of the JAX package's
    ``init_depth_pro`` (same keys, shapes and distributions; zero biases,
    as the reference zero-inits the final head bias)."""
    device = torch.device(device)
    d = cfg.vit.embed_dim
    df = cfg.decoder_features
    dims = cfg.dims_encoder

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def zeros(n):
        return torch.zeros((n,), device=device)

    def conv_w(kh, kw, i, o):
        return nrm((kh, kw, i, o), (kh * kw * i) ** -0.5)

    def deconv_w(i, o):
        return nrm((i, 4 * o), (4 * i) ** -0.5)

    def upsample(i_dim, o_dim, n, int_dim=None):
        int_dim = int_dim or o_dim
        return {"proj_w": conv_w(1, 1, i_dim, int_dim),
                "deconvs": [deconv_w(int_dim if j == 0 else o_dim, o_dim) for j in range(n)]}

    enc = {
        "patch_vit": init_vit(cfg.vit, generator, device),
        "image_vit": init_vit(cfg.vit, generator, device),
        "upsample_latent0": upsample(d, df, 3, int_dim=dims[0]),
        "upsample_latent1": upsample(d, dims[0], 2),
        "upsample0": upsample(d, dims[1], 1),
        "upsample1": upsample(d, dims[2], 1),
        "upsample2": upsample(d, dims[3], 1),
        "upsample_lowres": {"w": deconv_w(d, dims[3]), "b": zeros(dims[3])},
        "fuse_lowres": {"w": conv_w(1, 1, 2 * dims[3], dims[3]), "b": zeros(dims[3])},
    }

    def res():
        return {"w1": conv_w(3, 3, df, df), "b1": zeros(df),
                "w2": conv_w(3, 3, df, df), "b2": zeros(df)}

    def fusion(deconv):
        return {"res1": res(), "res2": res(),
                "deconv_w": deconv_w(df, df) if deconv else None,
                "out": {"w": conv_w(1, 1, df, df), "b": zeros(df)}}

    dec_dims = (df,) + tuple(dims)
    dec = {
        "convs": [None] + [conv_w(3, 3, dim, df) for dim in dec_dims[1:]],
        "fusions": [fusion(deconv=(i != 0)) for i in range(len(dec_dims))],
    }
    head = {
        "conv_in": {"w": conv_w(3, 3, df, df // 2), "b": zeros(df // 2)},
        "deconv": {"w": deconv_w(df // 2, df // 2), "b": zeros(df // 2)},
        "conv_mid": {"w": conv_w(3, 3, df // 2, 32), "b": zeros(32)},
        "conv_out": {"w": conv_w(1, 1, 32, 1), "b": zeros(1)},
    }
    params = {"encoder": enc, "decoder": dec, "head": head}
    if cfg.use_fov_head:
        k = max(cfg.vit.grid_size // 4, 1)
        params["fov"] = {
            "vit": init_vit(cfg.vit, generator, device),
            "proj": {"w": nrm((d, df // 2), d**-0.5), "b": zeros(df // 2)},
            "down": {"w": conv_w(3, 3, df, df // 2), "b": zeros(df // 2)},
            "head": [
                {"w": conv_w(3, 3, df // 2, df // 4), "b": zeros(df // 4)},
                {"w": conv_w(3, 3, df // 4, df // 8), "b": zeros(df // 8)},
                {"w": conv_w(k, k, df // 8, 1), "b": zeros(1)},
            ],
        }
    return params


class ParamTree(nn.Module):
    """A param tree held as this module's (frozen) parameters, so that
    ``.to()``, ``state_dict()`` and ``parameters()`` see it; the int8 codes
    of a quantized tree are frozen parameters too. ``tree()`` gives the
    nested structure back (``{'q', 's'}`` dicts included), sharing the
    parameters' storage."""

    def __init__(self, tree):
        super().__init__()
        self._skeleton = self._register(tree, ())

    def _register(self, node, path):
        if isinstance(node, dict):
            return {k: self._register(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [self._register(v, path + (str(i),)) for i, v in enumerate(node)]
        if node is None:
            return None
        name = "__".join(path)
        self.register_parameter(name, nn.Parameter(torch.as_tensor(node), requires_grad=False))
        return name

    def tree(self):
        return map_tree(lambda name: getattr(self, name), self._skeleton)
