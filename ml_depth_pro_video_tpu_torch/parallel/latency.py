"""Single-frame LATENCY parallelism over ranks (twin of ``ml_depth_pro_video_tpu/parallel/latency.py``).

Data parallelism (``parallel/spmd.py``) scales frames per second; this
module splits ONE frame's forward over every rank:

- the 35-patch pyramid ViT, the dominant cost, is split over the patch
  axis: the B*35 patches pad to a multiple of the rank count (the padded
  share is logged, as the JAX package does), each rank runs its slice
  through the whole backbone (K1, and K3 at the speed tiers, with the merge
  per patch slice), and one all_gather per tensor returns the tokens and
  both hook captures;
- the decoder and the depth head run on row bands. In the JAX package GSPMD
  shards them along image rows and exchanges the halos itself; here every
  rank holds a band of rows of every encoding (:class:`RowBands`) and, before
  each 3x3 conv, takes one halo row from each neighbour, point to point
  (``multihost.exchange``, only the two neighbours); before a fused residual
  block it takes two, runs K2 on the band plus halo and crops. The
  2x2 transposed convs and the 1x1 convs need no halo. The bands of the
  canonical map (and of the FOV head's low-resolution features) are
  gathered before the output is resized;
- the image and FOV ViTs (one patch each) run whole on every rank.

The halo is exchanged per conv, not once as a band overlapping by the
decoder's whole receptive field: the receptive field grows through the five
levels and their upsamplings to tens of rows at the finest ones, while a
per-conv halo of one or two rows keeps every rank's work at its band and
the results equal to the unsharded decoder's.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core.precision import Precision
from ..models.depth_pro import DepthProConfig, infer_fn
from ..models.vit import vit_apply
from . import multihost
from .mesh import Mesh

LOGGER = logging.getLogger(__name__)


def make_sp_mesh(ranks=None) -> Mesh:
    """A flat one-axis mesh ("sp") over ``ranks`` (every rank by default)."""
    ranks = list(range(multihost.world_size())) if ranks is None else [int(r) for r in ranks]
    return Mesh(np.asarray(ranks), ("sp",))


def _position(mesh: Mesh) -> int:
    if mesh.size != multihost.world_size():
        raise ValueError(f"latency mode needs a mesh over every rank: mesh of {mesh.size}, "
                         f"{multihost.world_size()} ranks")
    return mesh.ranks.index(multihost.rank())


def _gather_in_mesh_order(t: torch.Tensor, mesh: Mesh, shapes=None) -> list[torch.Tensor]:
    """The mesh positions' ``t`` in mesh order (``shapes`` in mesh order too)."""
    by_rank = None
    if shapes is not None:
        by_rank = [None] * mesh.size
        for r, s in zip(mesh.ranks, shapes):
            by_rank[r] = s
    pieces = multihost.all_gather(t, by_rank)
    return [pieces[r] for r in mesh.ranks]


class RowBands:
    """This rank's band of the decoder's image rows. Every decoder level is a
    whole multiple k of the ViT's token grid (``grid`` rows: the fused
    low-resolution level is 2 grids high, the finest 32), so the grid's rows
    are split over the ranks (sizes differing by at most one) and a level's
    band is its k-fold: upsampling a band gives the next level's band."""

    def __init__(self, grid: int, mesh: Mesh):
        n = mesh.size
        if n > grid:
            raise ValueError(f"latency mode splits the {grid} token-grid rows over the ranks: "
                             f"{n} ranks are too many")
        self.mesh = mesh
        self.grid = grid
        self.sizes = [grid // n + (1 if i < grid % n else 0) for i in range(n)]
        self.index = _position(mesh)
        self.lo = sum(self.sizes[:self.index])
        self.hi = self.lo + self.sizes[self.index]
        self.above = self.index > 0
        self.below = self.index < n - 1

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's band of a whole NHWC level."""
        h = t.shape[1]
        if h % self.grid:
            raise ValueError(f"a level of {h} rows is not a multiple of the {self.grid}-row grid")
        k = h // self.grid
        return t[:, k * self.lo:k * self.hi]

    def extend(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The band with ``n`` halo rows from each neighbour (none at the image's
        own top and bottom, where the convs' zero padding belongs)."""
        if self.mesh.size == 1:
            return x
        if x.shape[1] < n:
            raise ValueError(f"a band of {x.shape[1]} rows cannot give a halo of {n}")
        up = self.mesh.ranks[self.index - 1] if self.above else None
        down = self.mesh.ranks[self.index + 1] if self.below else None
        sends = {}
        if up is not None:
            sends[up] = x[:, :n]
        if down is not None:
            sends[down] = x[:, -n:]
        got = multihost.exchange(sends)
        parts = [got[up]] if up is not None else []
        parts.append(x)
        if down is not None:
            parts.append(got[down])
        return torch.cat(parts, dim=1)

    def crop(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """Drop the halo rows that :meth:`extend` added."""
        lo = n if self.above else 0
        return y[:, lo:y.shape[1] - (n if self.below else 0)]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole level from every rank's band, on every rank."""
        if self.mesh.size == 1:
            return t
        k = t.shape[1] // self.sizes[self.index]
        shapes = [(t.shape[0], k * s) + tuple(t.shape[2:]) for s in self.sizes]
        return torch.cat(_gather_in_mesh_order(t, self.mesh, shapes), dim=1)


def patch_split(n_patches: int, n_ranks: int) -> tuple[int, int]:
    """(padded patch count, patches per rank) of the latency split."""
    padded = n_patches + (-n_patches) % n_ranks
    return padded, padded // n_ranks


def _sharded_patch_vit(mesh: Mesh, cfg: DepthProConfig, precision: Precision):
    """patch_vit_fn: pad the patch axis to the rank count, run this rank's
    slice through the backbone, gather the tokens and both captures."""
    index = _position(mesh)
    logged: set = set()

    def patch_vit_fn(vp, pyramid):
        nb = pyramid.shape[0]
        padded, per = patch_split(nb, mesh.size)
        if padded > nb:
            if nb not in logged:
                logged.add(nb)
                LOGGER.info("latency mode: %d patches pad to %d on %d ranks (%.1f%% padded "
                            "patch-ViT compute)", nb, padded, mesh.size,
                            100.0 * (padded - nb) / padded)
            pyramid = torch.cat([pyramid, pyramid.new_zeros((padded - nb,) + pyramid.shape[1:])])
        # merge args forwarded: the speed tiers merge per patch, so per slice
        t, (h0, h1) = vit_apply(vp, pyramid[index * per:(index + 1) * per], cfg.vit, precision,
                                capture_blocks=cfg.hook_block_ids,
                                merge_ratio=cfg.token_merge_ratio,
                                merge_block=cfg.token_merge_block)
        t, h0, h1 = (torch.cat(_gather_in_mesh_order(a, mesh))[:nb] for a in (t, h0, h1))
        return t, (h0, h1)

    return patch_vit_fn


def make_latency_infer(cfg: DepthProConfig, mesh: Mesh | None = None,
                       precision: Precision = Precision.fp32(), derive_missing: bool = False,
                       interpolation_mode: str = "bilinear", preprocess=None):
    """The forward with the model itself split over the ranks:
    ``fn(params, x, f_px=None) -> {"depth", "focallength_px"}`` with x (B, H,
    W, 3) and f_px (B,) or None, whole on every rank. Every rank calls it with
    the same inputs. The contract IS ``models.depth_pro.infer_fn``: this only
    passes its two latency hooks, so a change to ``infer_fn`` applies here."""
    mesh = mesh if mesh is not None else make_sp_mesh()
    patch_vit_fn = _sharded_patch_vit(mesh, cfg, precision)
    rows = RowBands(cfg.vit.grid_size, mesh)

    def fn(params, x, f_px=None):
        if preprocess is not None:
            x = preprocess(x)
        return infer_fn(params, x, f_px, cfg, precision, interpolation_mode,
                        derive_missing=derive_missing, patch_vit_fn=patch_vit_fn, rows=rows)

    return fn
