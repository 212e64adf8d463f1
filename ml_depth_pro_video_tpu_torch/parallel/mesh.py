"""Meshes over ranks (twin of ``ml_depth_pro_video_tpu/parallel/mesh.py``).

A JAX mesh lays devices out on named axes; here a mesh lays the ranks of
the process group out the same way, one rank per device
(``parallel/multihost.py``). Frames are data-parallel over ``dp``; ``tp``
replicates them (tensor parallelism is the training half, not ported yet).
A :class:`Sharding` says which rows of a batch each rank holds: split over
``dp`` in contiguous blocks (:func:`batch_sharding`), or all of them
(:func:`replicated`).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from . import multihost

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks on named axes: ``grid[i, j]`` is the rank at coordinate (i, j)."""

    grid: np.ndarray
    axis_names: tuple

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
