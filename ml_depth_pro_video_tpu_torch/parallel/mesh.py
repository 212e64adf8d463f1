"""Meshes over ranks (twin of ``ml_depth_pro_video_tpu/parallel/mesh.py``).

A JAX mesh lays devices out on named axes; here a mesh lays the ranks of
the process group out the same way, one rank per device
(``parallel/multihost.py``). Frames are data-parallel over ``dp``; ``tp``
replicates them and splits the ViT blocks' matmul weights
(``parallel/sharding.py``); a (dp, pp) mesh (``parallel/pipeline.py``)
splits the patch ViT's blocks along depth over ``pp``. A :class:`Sharding`
says which rows of a batch each rank holds: split over ``dp`` in contiguous
blocks (:func:`batch_sharding`), or all of them (:func:`replicated`).
:func:`with_groups` gives a mesh the process groups of its axes, which the
training collectives run on.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
import torch.distributed as dist

from . import multihost

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks on named axes: ``grid[i, j]`` is the rank at coordinate (i, j)."""

    grid: np.ndarray
    axis_names: tuple
    groups: dict = dataclasses.field(default_factory=dict)  # axis -> AxisGroup (with_groups)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def ranks(self) -> list[int]:
        return [int(r) for r in self.grid.flat]

    def coords(self, rank: int) -> tuple | None:
        """The rank's coordinate on the mesh, or None when it is not on it."""
        hit = np.argwhere(self.grid == rank)
        return None if len(hit) == 0 else tuple(int(i) for i in hit[0])

    def group(self, axis: str) -> "AxisGroup | None":
        """This rank's group along ``axis`` (:func:`with_groups`), or None where
        the axis has one rank or the mesh has no groups."""
        return self.groups.get(axis)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that share this rank's coordinates on every axis but one:
    their process group, the ranks in axis order, and this rank's index."""

    group: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def with_groups(mesh: Mesh) -> Mesh:
    """The mesh with a process group per axis line, for every axis longer
    than one rank. ``dist.new_group`` is collective: every rank of the group
    calls this with the same mesh and creates every line's group, in the same
    order, keeping its own. The groups take the tensor collectives' backend
    (``multihost.cluster``); one all_reduce on each of this rank's groups
    sets their communicators up before the first point-to-point step. A
    single process has no groups."""
    c = multihost.cluster()
    if c is None:
        return mesh
    me = multihost.rank()
    groups = {}
    for a, name in enumerate(mesh.axis_names):
        if mesh.grid.shape[a] == 1:
            continue
        for line in np.moveaxis(mesh.grid, a, -1).reshape(-1, mesh.grid.shape[a]):
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(sorted(ranks), backend=c.backend)
            if me in ranks:
                groups[name] = AxisGroup(group, ranks, ranks.index(me))
    device = torch.device("cuda", torch.cuda.current_device()) if c.backend == "nccl" else "cpu"
    for g in [None, *(ag.group for ag in groups.values())]:
        multihost.all_reduce(torch.zeros(1, device=device), g)
    return dataclasses.replace(mesh, groups=groups)


def make_mesh(dp: int | None = None, tp: int = 1, ranks=None) -> Mesh:
    """A (dp, tp) mesh over ``ranks`` (every rank of the group by default);
    ``dp`` defaults to ``len(ranks) // tp``. Asking for more ranks than there
    are raises, as the JAX package's oversubscription does."""
    ranks = list(range(multihost.world_size())) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if dp is None:
        dp = n // tp
    if dp * tp > n or dp == 0 or tp == 0:
        raise ValueError(f"mesh {dp}x{tp} needs {max(dp, 1) * max(tp, 1)} devices, have {n}")
    return Mesh(np.asarray(ranks[:dp * tp]).reshape(dp, tp), ("dp", "tp"))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which rows of a batch each rank of ``mesh`` holds: split in contiguous
    blocks over ``axis``, or every row when ``axis`` is None."""

    mesh: Mesh
    axis: str | None

    def rows(self, rank: int, n: int) -> list[int]:
        """The rows of an ``n``-row batch on ``rank`` (none off the mesh)."""
        at = self.mesh.coords(rank)
        if at is None:
            return []
        if self.axis is None:
            return list(range(n))
        parts = self.mesh.shape[self.axis]
        if n % parts:
            raise ValueError(f"a batch of {n} rows does not split over {self.axis}={parts}: "
                             "round it with round_batch_to_dp")
        i = at[self.mesh.axis_names.index(self.axis)]
        step = n // parts
        return list(range(i * step, (i + 1) * step))


def batch_sharding(mesh: Mesh) -> Sharding:
    """Split the leading (frame) dim over dp, replicate it over tp."""
    return Sharding(mesh, "dp")


def round_batch_to_dp(batch_size: int, mesh: Mesh) -> int:
    """Round ``batch_size`` UP to a multiple of the mesh's dp degree: the one
    rounding rule of the runner and the exporter."""
    dp = mesh.shape.get("dp", 1)
    if batch_size % dp:
        rounded = ((batch_size + dp - 1) // dp) * dp
        LOGGER.info("batch_size %d -> %d (multiple of dp=%d)", batch_size, rounded, dp)
        return rounded
    return batch_size


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
