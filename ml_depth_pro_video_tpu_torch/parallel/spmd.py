"""Data-parallel inference over ranks (twin of ``ml_depth_pro_video_tpu/parallel/spmd.py``).

The JAX package wraps the per-frame program in ``shard_map``: every chip
runs the whole program on its slice of the batch, params replicated, no
cross-chip traffic in the forward. Here every rank does the same on its
rows (``mesh.batch_sharding``) on its own device, launching the same
kernels as one device does; one :func:`multihost.all_gather` returns the
whole batch where the caller wants it.
"""

from __future__ import annotations

import torch

from . import multihost
from .mesh import Mesh, batch_sharding


def gather_rows(out, mesh: Mesh):
    """The whole batch of a per-rank result tree (dicts of tensors whose leading
    dim is the rank's rows), on every rank: one all_gather per leaf, the
    pieces of the tp-coordinate-0 ranks concatenated in dp order."""
    if isinstance(out, dict):
        return {k: gather_rows(v, mesh) for k, v in out.items()}
    pieces = multihost.all_gather(out)
    return torch.cat([pieces[int(r)] for r in mesh.grid[:, 0]], dim=0)


def make_dp_infer(infer_fn, mesh: Mesh, n_batch_args: int = 1):
    """Wrap ``infer_fn(params, *batch_args) -> tree`` for data-parallel
    execution over the mesh's ``dp`` axis: each of the ``n_batch_args``
    trailing arguments (the whole batch on every rank; None passes through)
    is cut to this rank's rows, and the result tree comes back whole on
    every rank. The mesh must hold every rank of the group (each one takes
    part in the gather), and the batch must be a multiple of dp
    (``round_batch_to_dp``). A rank that has only its own rows runs
    ``infer_fn`` on them directly (``DepthVideoRunner.depth_stream_multihost``)."""
    if mesh.size != multihost.world_size():
        raise ValueError(f"a dp program needs a mesh over every rank: mesh of {mesh.size}, "
                         f"{multihost.world_size()} ranks")
    sharding = batch_sharding(mesh)

    def fn(params, *args):
        batch, rest = args[:n_batch_args], args[n_batch_args:]
        n = next(len(a) for a in batch if a is not None)
        rows = multihost.local_rows(sharding, (n,))
        part = [None if a is None else a[rows[0]:rows[-1] + 1] for a in batch]
        return gather_rows(infer_fn(params, *part, *rest), mesh)

    return fn
