"""Tensor parallelism for the ViT blocks (twin of ``ml_depth_pro_video_tpu/parallel/sharding.py``).

Megatron-style TP: the qkv and fc1 weights split by columns over ``tp``,
proj and fc2 by rows (their contracting dim), so each block makes one sum
over the tp group after attention and one after the MLP. The JAX package
writes these rules as GSPMD annotations and XLA inserts the sums; here each
rank holds its shard (:func:`shard_params`) and the block calls the two
autograd functions of Megatron TP on the rank's tp group
(:class:`TensorParallel`, ``models/vit.py::_block``):

- *copy to tp* before the qkv and fc1 GEMMs: identity forward, all-reduce
  backward (each rank's columns contribute a part of the input's gradient);
- *reduce from tp* after the proj and fc2 GEMMs: all-reduce forward (each
  rank's rows give a partial product), identity backward; the bias is added
  once, after the sum.

This works because the qkv projection is packed head-contiguously (columns
``[h0:(q,k,v) | h1:(q,k,v) | ...]``, ``ckpt/convert.py``), so a column
shard hands each tp rank whole heads: attention (kernel K1) runs on the
rank's ``num_heads // tp`` heads. The rules apply to every ``blocks``
subtree (the patch, image and FOV ViTs); block params are stacked (L, ...),
so they split trailing dims. Everything else is replicated.

A split is written as a spec: a tuple with an axis name at the split dim
(``(None, None, "tp")``: the last of three dims), ``()`` for replicated,
as ``tuple(PartitionSpec)`` reads in the JAX package. :func:`shard_leaf`
and :func:`gather_leaf` cut and rebuild a leaf by any spec over the mesh's
axis groups (``parallel/mesh.py::with_groups``); the GPipe layout
(``parallel/pipeline.py``) uses them with ``("pp",)``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ckpt.params import _map_with_path
from . import multihost
from .mesh import Mesh

# stacked ViT block param name -> spec (leading axis = depth L)
_TP_RULES = {
    "qkv_w": (None, None, "tp"),
    "qkv_b": (None, "tp"),
    "fc1_w": (None, None, "tp"),
    "fc1_b": (None, "tp"),
    "proj_w": (None, "tp", None),
    "fc2_w": (None, "tp", None),
}
# int8-quantized weights {'q': (L, din, dout) int8, 's': (L, 1, dout)}:
# column-ruled weights shard with their per-output-channel scale; the
# row-ruled ones (proj/fc2) stay replicated when quantized (the scale
# is per OUTPUT channel and cannot follow a contracting-dim shard)
_TP_QUANT_RULES = {
    "qkv_w": {"q": (None, None, "tp"), "s": (None, None, "tp")},
    "fc1_w": {"q": (None, None, "tp"), "s": (None, None, "tp")},
}


def check_heads(num_heads: int, tp: int) -> None:
    """Raise unless ``tp`` divides the heads: the head-contiguous packing
    hands each tp shard whole heads only then."""
    if tp > 1 and num_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={num_heads} "
            f"(e.g. the 'small' preset has 6 heads: use tp in (2, 3, 6))")


def param_shardings(params, mesh: Mesh, tensor_parallel: bool = True):
    """The spec of every leaf of ``params`` (a tree of the same structure,
    None where ``params`` has None)."""
    split = tensor_parallel and mesh.shape.get("tp", 1) > 1

    def spec_for(path, leaf) -> tuple:
        keys = list(path)
        # only stacked ViT block params (under a "blocks" subtree)
        if split and "blocks" in keys:
            if keys[-1] in _TP_RULES:
                return _TP_RULES[keys[-1]]
            # int8-quantized leaf: {'q','s'} under the weight name
            if len(keys) >= 2 and keys[-1] in ("q", "s") and keys[-2] in _TP_QUANT_RULES:
                return _TP_QUANT_RULES[keys[-2]][keys[-1]]
        return ()

    return _map_with_path(spec_for, params)


def _split_dim(spec: tuple) -> tuple:
    """(dim, axis) of the one split in ``spec``, or (None, None)."""
    for d, axis in enumerate(spec):
        if axis is not None:
            return d, axis
    return None, None


def shard_leaf(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along the split of ``spec`` (a
    copy), or ``t`` itself where the spec replicates it."""
    d, axis = _split_dim(spec)
    group = None if axis is None else mesh.group(axis)
    if group is None:
        return t
    n = t.shape[d] // group.size
    return t.narrow(d, group.index * n, n).clone()


def gather_leaf(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's block of it (the inverse of
    :func:`shard_leaf`; collective over the split axis's group)."""
    d, axis = _split_dim(spec)
    group = None if axis is None else mesh.group(axis)
    if group is None:
        return t
    pieces = multihost.all_gather(t, group=group.group)  # in ascending rank order
    order = sorted(group.ranks)
    return torch.cat([pieces[order.index(r)] for r in group.ranks], dim=d)


def _zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_specs(fn, v, s) for v, s in zip(tree, specs)]
    return None if tree is None else fn(tree, specs)


def shard_params(params, mesh: Mesh, tensor_parallel: bool = True, specs=None):
    """This rank's shard of ``params`` by the TP rules, or by ``specs`` (a
    spec tree of the same structure; a list of specs for a list of leaves)."""
    specs = param_shardings(params, mesh, tensor_parallel) if specs is None else specs
    return _zip_specs(lambda t, s: shard_leaf(t, s, mesh), params, specs)


def gather_params(local, mesh: Mesh, tensor_parallel: bool = True, specs=None, device=None):
    """The whole tree from every rank's shard (collective; the inverse of
    :func:`shard_params`, for checkpoints), each leaf moved to ``device``
    when given as soon as it is whole."""
    specs = param_shardings(local, mesh, tensor_parallel) if specs is None else specs

    def gather(t, s):
        t = gather_leaf(t, s, mesh)
        return t if device is None else t.to(device)

    return _zip_specs(gather, local, specs)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return multihost.all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial products summed over the tp group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return multihost.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The tp context of a ViT block: the rank's tp group and its size.
    Every rank of the group calls :meth:`copy` and :meth:`reduce` at the same
    points, in the same order (in a recomputed block's backward too)."""

    group: object
    size: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """*Copy to tp*: the input of a column-split GEMM."""
        return _CopyToTP.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """*Reduce from tp*: the sum of a row-split GEMM's partial products."""
        return _ReduceFromTP.apply(x, self.group)


BUCKET_BYTES = 64 << 20  # the most a flat buffer of the dp gradient sum holds


@dataclasses.dataclass
class Layout:
    """How a training state's params lie over the ranks of a mesh with
    groups (``parallel/mesh.py::with_groups``): ``specs`` is the spec tree of
    the params, by the TP rules (:func:`param_shardings`) on a (dp, tp) mesh
    or by the patch ViT's depth split on a (dp, pp) mesh
    (``parallel/pipeline.py``); ``leaf_specs`` the same, one per leaf in
    ``train/step.py::tree_leaves`` order. :func:`shard_params` and
    :func:`gather_params` cut and rebuild a tree by ``specs`` and a list of
    leaves (the AdamW moments) by ``leaf_specs``. The batch is split over
    ``dp``."""

    mesh: Mesh
    specs: object
    leaf_specs: list
    microbatches: int = 0  # GPipe microbatches per step, on a (dp, pp) mesh

    @classmethod
    def build(cls, mesh: Mesh, params, specs, microbatches: int = 0) -> "Layout":
        flat: list = []
        _zip_specs(lambda t, s: flat.append(s), params, specs)
        return cls(mesh, specs, flat, microbatches)

    @property
    def pp(self) -> int:
        return self.mesh.shape.get("pp", 1)

    @property
    def tp(self) -> TensorParallel | None:
        g = self.mesh.group("tp")
        return None if g is None else TensorParallel(g.group, g.size)

    def group(self, axis: str):
        """The process group of this rank along ``axis``, None for one rank."""
        g = self.mesh.group(axis)
        return None if g is None else g.group

    def sum_dp(self, grads: list) -> None:
        """Sum the gradients over the dp group, in place of the list's entries:
        one all_reduce per flat buffer of at most ``BUCKET_BYTES`` (a larger
        leaf alone), per dtype. A ``None`` (a leaf the loss does not reach,
        the same on every rank) is left out."""
        group = self.group("dp")
        if group is None:
            return
        by_dtype: dict = {}
        for i, g in enumerate(grads):
            if g is not None:
                by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            bucket, size = [], 0
            for i in idx + [None]:
                nbytes = 0 if i is None else grads[i].numel() * grads[i].element_size()
                if bucket and (i is None or size + nbytes > BUCKET_BYTES):
                    flat = multihost.all_reduce(
                        torch.cat([grads[j].reshape(-1) for j in bucket]), group)
                    for j, piece in zip(bucket, flat.split([grads[j].numel() for j in bucket])):
                        grads[j] = piece.view_as(grads[j])
                    bucket, size = [], 0
                if i is not None:
                    bucket.append(i)
                    size += nbytes

    def global_norm(self, norms: torch.Tensor, idx: list) -> torch.Tensor:
        """The L2 norm of the whole model's gradient from the local leaves'
        norms (``norms[k]`` of leaf ``idx[k]``): a split leaf's square summed
        over its group once, a replicated one counted once."""
        split = [k for k, i in enumerate(idx) if self.leaf_specs[i]]
        group = self.group("pp" if self.pp > 1 else "tp")
        if group is None or not split:
            return torch.linalg.vector_norm(norms)
        mask = torch.zeros(len(idx), dtype=torch.bool, device=norms.device)
        mask[split] = True
        sq = torch.square(norms)
        shards = multihost.all_reduce(sq[mask].sum(), group)
        return torch.sqrt(sq[~mask].sum() + shards)
