"""Fine-tuning step for Depth Pro, on one device or across ranks.

Twin of ``ml_depth_pro_video_tpu/train/step.py``: a scale-invariant log-depth
loss, AdamW with global-norm clipping and a warmup + cosine schedule, and
gradient accumulation, in PyTorch. The optimizer is written out here, with
optax's formulas in optax's order, so that the same gradients give the same
updates as the JAX package's ``optax`` chain:

- AdamW (``optax.adamw``): ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2
  nu``, bias corrections ``1 - b^count`` in fp32, ``u = mu_hat /
  (sqrt(nu_hat) + eps) + wd p``, ``p += -lr(count) u``. Every leaf is updated
  and decayed, a leaf that got no gradient too (the FOV head's, which the loss
  skips): it counts as a zero gradient, as in optax, where ``torch.optim``
  would leave it alone;
- clipping (``optax.clip_by_global_norm``): ``g`` is kept when ``|g| < c``,
  else becomes ``(g / |g|) c`` (not ``torch.nn.utils.clip_grad_norm_``'s
  ``c / (|g| + 1e-6)``);
- the schedule advances once per APPLIED update, with the JAX package's
  conversion of data batches to updates, values equal to
  ``optax.warmup_cosine_decay_schedule`` / ``cosine_decay_schedule``;
- ``grad_accum = k > 1`` (``optax.MultiSteps``): a running mean of k
  batches' gradients, then one clipped AdamW update; ``TrainState.step``
  counts data batches, the schedule counts updates.

Params, moments and the accumulator are updated in place (the JAX package
donates its state instead).

Across ranks (``make_train_step(dp=, tp=, pp=)``, one process per rank, the
twin of ``make_sharded_train_step`` and, for ``pp``, of
``parallel/pipeline.py::make_pp_train_step``) a state carries its
``parallel/sharding.py::Layout``: each rank holds its shard of the params
and of the moments, takes its rows of the global batch, and gets the loss
and the gradients of the one-rank step on that batch. Three traps:

- the global SILog: the loss is the SILog of the whole batch, whose
  lambda * mean^2 term is not linear in the split, so a mean of per-rank
  losses (DDP's) is another loss with another gradient; and differentiating
  a loss an all-reduce made equal on every rank would count the gradient
  once per rank. Each rank differentiates its own share against the batch's
  reduced sums (``global_silog``), then the gradients are summed over dp;
- the global norm that clipping uses is the whole model's: a tp- or
  pp-split leaf's square summed over its group once, a replicated leaf's
  counted once (``Layout.global_norm``); AdamW stays elementwise on the
  local shards;
- a leaf without a gradient (the FOV head's) is decayed as a zero gradient
  on every rank, as on one, and never all-reduced.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import numpy as np
import torch

from ..ckpt.params import map_tree
from ..core.precision import Precision, disable_tf32, resolve_device
from ..models.depth_pro import DepthProConfig, forward
from ..parallel import multihost
from ..parallel.mesh import make_mesh, with_groups
from ..parallel.sharding import (
    Layout,
    check_heads,
    gather_params,
    param_shardings,
    shard_params,
)

LOGGER = logging.getLogger(__name__)

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


def tree_leaves(tree) -> list:
    """The tensors of a param tree, in the tree's (insertion) order."""
    out: list = []
    map_tree(out.append, tree)
    return out


@dataclasses.dataclass
class OptState:
    """AdamW moments per leaf (in ``tree_leaves`` order), the count of applied
    updates (the schedule's and the bias corrections' count), and, with
    gradient accumulation, the running mean and the batches in it."""

    count: int
    mu: list
    nu: list
    mini_step: int = 0
    acc: list | None = None


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: OptState
    step: int  # data batches trained
    layout: Layout | None = None  # across ranks: this rank holds its shard

    def to_dict(self) -> dict:
        """The state as plain dicts, lists, tensors and ints, in the one-rank
        layout: what a checkpoint holds (``ckpt/checkpointing.py``). A sharded
        state is gathered onto the host (collective: every rank calls it)."""
        opt, lay = self.opt_state, self.layout
        if lay is None:
            return {"params": map_tree(lambda t: t.detach(), self.params),
                    "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu,
                                  "mini_step": opt.mini_step, "acc": opt.acc},
                    "step": int(self.step)}

        def gather(tree, specs):
            return gather_params(tree, lay.mesh, specs=specs, device="cpu")

        return {"params": gather(map_tree(lambda t: t.detach(), self.params), lay.specs),
                "opt_state": {"count": opt.count, "mu": gather(opt.mu, lay.leaf_specs),
                              "nu": gather(opt.nu, lay.leaf_specs), "mini_step": opt.mini_step,
                              "acc": None if opt.acc is None else gather(opt.acc, lay.leaf_specs)},
                "step": int(self.step)}

    @classmethod
    def from_dict(cls, d: dict, layout: Layout | None = None, device=None) -> "TrainState":
        """The inverse of ``to_dict``: cut for ``layout`` (this rank's shard)
        and put on ``device`` when given; the params become leaves that
        require grad."""
        o = d["opt_state"]
        params, mu, nu, acc = d["params"], o["mu"], o["nu"], o["acc"]
        if layout is not None:
            mesh, leaf_specs = layout.mesh, layout.leaf_specs
            params = shard_params(params, mesh, specs=layout.specs)
            mu, nu = (shard_params(m, mesh, specs=leaf_specs) for m in (mu, nu))
            acc = None if acc is None else shard_params(acc, mesh, specs=leaf_specs)
        if device is not None:
            params = map_tree(lambda t: t.to(device), params)
            mu, nu = [t.to(device) for t in mu], [t.to(device) for t in nu]
            acc = None if acc is None else [t.to(device) for t in acc]
        return cls(params=map_tree(lambda t: t.requires_grad_(), params),
                   opt_state=OptState(count=o["count"], mu=mu, nu=nu,
                                      mini_step=o["mini_step"], acc=acc),
                   step=d["step"], layout=layout)


def silog_loss(pred_inv_depth: torch.Tensor, target_depth: torch.Tensor,
               eps: float = 1e-6, lam: float = 0.85) -> torch.Tensor:
    """Scale-invariant log loss (Eigen et al.) on depth derived from the
    predicted canonical inverse depth.

    Invalid target pixels (holes stored as 0, negative or NaN) are masked
    out; without the mask a single hole contributes log(eps)^2 ~ 190 to the
    loss (or NaNs the gradients)."""
    pred_depth = 1.0 / torch.clamp(pred_inv_depth, eps, 1e4)
    valid = torch.isfinite(target_depth) & (target_depth > 0)
    target = torch.where(valid, target_depth, torch.ones_like(target_depth))
    g = torch.where(valid, torch.log(torch.clamp(pred_depth, min=eps)) - torch.log(target),
                    torch.zeros_like(pred_depth))
    n = torch.clamp(valid.sum(), min=1)
    mean_g2 = torch.sum(torch.square(g)) / n
    mean_g = torch.sum(g) / n
    return mean_g2 - lam * torch.square(mean_g)


def global_silog(pred_inv_depth: torch.Tensor, target_depth: torch.Tensor, group=None,
                 eps: float = 1e-6, lam: float = 0.85) -> tuple:
    """(the SILog of the batch split over ``group``, this rank's share of
    it; ``group`` None: this rank's batch alone). The batch's sums (squares,
    values, valid pixels) are all-reduced in float64 and held constant; the share is linear in this rank's sums, with
    the gradient of ``silog_loss`` on the whole batch once summed over the
    group: d(S2/N - lam (S1/N)^2) = dS2/N - 2 lam (S1/N) dS1/N."""
    pred_depth = 1.0 / torch.clamp(pred_inv_depth, eps, 1e4)
    valid = torch.isfinite(target_depth) & (target_depth > 0)
    target = torch.where(valid, target_depth, torch.ones_like(target_depth))
    g = torch.where(valid, torch.log(torch.clamp(pred_depth, min=eps)) - torch.log(target),
                    torch.zeros_like(pred_depth))
    s2, s1 = torch.sum(torch.square(g)), torch.sum(g)
    sums = torch.stack([s2.detach().double(), s1.detach().double(), valid.sum().double()])
    if group is not None:
        sums = multihost.all_reduce(sums, group)
    n = torch.clamp(sums[2], min=1)
    mean_g = sums[1] / n
    loss = (sums[0] / n - lam * torch.square(mean_g)).float()
    return loss, s2 / n.float() - (2 * lam * mean_g).float() * s1 / n.float()


def _f32(x) -> np.float32:
    return np.float32(x)


def cosine_decay(init_value: float, decay_steps: int):
    """``optax.cosine_decay_schedule`` (alpha 0, exponent 1), in fp32."""
    def schedule(count: int) -> float:
        c = _f32(min(count, decay_steps))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(decay_steps)))
        return float(_f32(init_value) * cos)

    return schedule


def warmup_cosine_decay(peak_value: float, warmup_steps: int, decay_steps: int):
    """``optax.warmup_cosine_decay_schedule`` from 0 to ``peak_value`` and
    down to 0, in fp32: a linear ramp over ``warmup_steps``, then a cosine
    over ``decay_steps - warmup_steps``."""
    cosine = cosine_decay(peak_value, decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        frac = _f32(1) - _f32(min(max(count, 0), warmup_steps)) / _f32(warmup_steps)
        return float(_f32(-peak_value) * frac + _f32(peak_value))

    return schedule


class AdamW:
    """Clipped AdamW with an optional schedule and gradient accumulation:
    the optax chain of the JAX package's ``make_optimizer``, on lists of
    tensors. ``init(params)`` makes the state; ``update(grads, state,
    params)`` takes one data batch's gradients (a list aligned with
    ``tree_leaves(params)``, ``None`` for a leaf without one) and updates
    params and state in place."""

    def __init__(self, lr, weight_decay: float = 1e-2, clip_norm: float | None = 1.0,
                 grad_accum: int = 1):
        self.lr = lr if callable(lr) else (lambda count, v=float(lr): v)
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.grad_accum = grad_accum

    def init(self, params) -> OptState:
        leaves = tree_leaves(params)
        zeros = lambda: [torch.zeros_like(p) for p in leaves]  # noqa: E731
        return OptState(count=0, mu=zeros(), nu=zeros(),
                        acc=zeros() if self.grad_accum > 1 else None)

    @torch.no_grad()
    def update(self, grads: list, state: OptState, params, layout: Layout | None = None) -> bool:
        """One data batch. Returns whether an update was applied (always
        without accumulation; every ``grad_accum``-th batch with it).
        ``layout``: the params are this rank's shard, and the clipping norm
        is the whole model's."""
        leaves = tree_leaves(params)
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} params")
        if self.grad_accum > 1:
            # optax.MultiSteps(use_grad_mean=True): acc + (g - acc) / (n + 1)
            n = state.mini_step + 1
            for acc, g in zip(state.acc, grads):
                acc.add_((-acc if g is None else g - acc) / n)
            state.mini_step += 1
            if state.mini_step < self.grad_accum:
                return False
            self._apply(state.acc, state, leaves, layout)  # reads the mean, writes no gradient
            torch._foreach_zero_(state.acc)
            state.mini_step = 0
            return True
        self._apply(grads, state, leaves, layout)
        return True

    def _apply(self, grads: list, state: OptState, leaves: list, layout=None) -> None:
        have = [i for i, g in enumerate(grads) if g is not None]
        none = [i for i, g in enumerate(grads) if g is None]
        g = [grads[i] for i in have]
        if self.clip_norm is not None and g:
            # optax: keep g where |g| < c, else (g / |g|) * c; chosen on the
            # device (no host sync): g / 1 * 1 is g exactly
            norms = torch.stack(torch._foreach_norm(g, 2))
            norm = (torch.linalg.vector_norm(norms) if layout is None
                    else layout.global_norm(norms, have))
            keep = norm < self.clip_norm
            g = torch._foreach_div(g, torch.where(keep, torch.ones_like(norm), norm))
            torch._foreach_mul_(g, torch.where(keep, torch.ones_like(norm),
                                               torch.full_like(norm, self.clip_norm)))
        mu, nu = [state.mu[i] for i in have], [state.nu[i] for i in have]
        if g:
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, g, alpha=1 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, g, g, value=1 - B2)
        if none:
            # a leaf without a gradient: (1-b) * 0 + b * m is b * m exactly
            torch._foreach_mul_([state.mu[i] for i in none], B1)
            torch._foreach_mul_([state.nu[i] for i in none], B2)
        count = state.count + 1
        bc1 = float(_f32(1) - _f32(B1) ** _f32(count))
        bc2 = float(_f32(1) - _f32(B2) ** _f32(count))
        # every leaf moves: one without a gradient by its decayed moments and
        # the weight decay, as in optax
        u = torch._foreach_div(state.mu, bc1)
        den = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(u, den)
        del den
        if self.weight_decay:
            torch._foreach_add_(u, leaves, alpha=self.weight_decay)
        torch._foreach_add_(leaves, u, alpha=-self.lr(state.count))
        state.count = count


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-2,
                   warmup_steps: int = 0, total_steps: int | None = None,
                   clip_norm: float | None = 1.0, grad_accum: int = 1) -> AdamW:
    """AdamW with optional global-norm clipping and a linear-warmup +
    cosine-decay schedule (``total_steps`` enables the schedule; without it
    the LR is constant). ``grad_accum > 1`` averages gradients over k data
    batches before one update (effective batch = batch_size x grad_accum);
    ``warmup_steps`` / ``total_steps`` stay in DATA batches and are
    converted to applied-update counts here, as in the JAX package."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    schedule = lr
    if total_steps is not None:
        # the schedule advances once per APPLIED update (ceil, so any
        # requested warmup survives accumulation); warmup_steps=0 means no
        # warmup, and a warmup that would swallow the run is truncated with
        # a warning
        total_updates = max(total_steps // grad_accum, 1)
        warmup_updates = -(-max(warmup_steps, 0) // grad_accum)
        if warmup_updates >= total_updates:
            # floor 0, not 1: a 1-update run with any warmup would run its
            # only update at lr 0
            warmup_updates = max(total_updates - 1, 0)
            LOGGER.warning(
                "warmup_steps=%d covers the whole %d-update run; truncating warmup to %d "
                "updates so the schedule reaches (and decays from) the requested peak LR",
                warmup_steps, total_updates, warmup_updates)
        if warmup_updates == 0:
            schedule = cosine_decay(lr, total_updates)
        else:
            schedule = warmup_cosine_decay(lr, warmup_updates,
                                           max(total_updates, warmup_updates + 1))
    return AdamW(schedule, weight_decay, clip_norm, grad_accum)


def check_degrees(tp: int, pp: int, grad_accum: int) -> None:
    """The JAX package's refusals of parallel degrees that do not combine."""
    if pp > 1 and tp > 1:
        raise ValueError("pp and tp cannot be combined (pick one of the ViT sharding modes)")
    if pp > 1 and grad_accum > 1:
        raise ValueError("grad_accum applies to the DPxTP step; the GPipe path already "
                         "microbatches (use --microbatches)")


def canonical_map(params, images, cfg: DepthProConfig, precision: Precision,
                  layout: Layout | None = None) -> torch.Tensor:
    """The canonical inverse depth (B, S, S) in fp32, the FOV head skipped, the
    ViT blocks recomputed in the backward pass (1536 px activations would not
    fit otherwise). With ``layout`` the params are this rank's shard: the
    blocks run tensor-parallel, or the patch ViT as GPipe stages, and every
    rank of the mesh calls this at the same point (the forward's collectives
    run in lock-step)."""
    patch_vit_fn = tp = None
    if layout is not None and layout.pp > 1:
        from ..parallel.pipeline import pp_patch_vit_fn

        patch_vit_fn = pp_patch_vit_fn(cfg, precision, layout, remat=True)
    elif layout is not None:
        tp = layout.tp
    canonical, _ = forward(params, images, cfg, precision, compute_fov=False, remat=True,
                           patch_vit_fn=patch_vit_fn, tp=tp)
    return canonical[..., 0].float()


def loss_fn(params, images, target_depth, cfg: DepthProConfig, precision: Precision,
            layout: Layout | None = None):
    """SILog of the canonical head (``canonical_map``), on this batch."""
    return silog_loss(canonical_map(params, images, cfg, precision, layout), target_depth)


def value_and_grad(params, images, target_depth, cfg: DepthProConfig, precision: Precision,
                   layout: Layout | None = None):
    """(loss, gradients aligned with ``tree_leaves(params)``, ``None`` for a
    leaf the loss does not reach). The params' leaves must require grad.
    With ``layout``: ``images`` and ``target_depth`` are this rank's rows of
    the global batch, the loss is the global batch's and the gradients this
    rank's shard of the one-rank step's."""
    leaves = tree_leaves(params)
    if layout is None:
        loss = loss_fn(params, images, target_depth, cfg, precision)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), list(grads)
    if layout.pp > 1:
        from ..parallel.pipeline import pp_value_and_grad

        loss, grads = pp_value_and_grad(params, images, target_depth, cfg, precision, layout)
    else:
        loss, share = global_silog(canonical_map(params, images, cfg, precision, layout),
                                   target_depth, layout.group("dp"))
        grads = list(torch.autograd.grad(share, leaves, allow_unused=True))
    layout.sum_dp(grads)
    return loss.detach(), grads


def train_step(state: TrainState, images, target_depth, cfg: DepthProConfig,
               optimizer: AdamW, precision: Precision = Precision.bf16()):
    """One step on one data batch (this rank's rows of it across ranks);
    ``state`` is updated in place and returned with the loss (a 0-d tensor
    on the device)."""
    loss, grads = value_and_grad(state.params, images, target_depth, cfg, precision,
                                 state.layout)
    optimizer.update(grads, state.opt_state, state.params, state.layout)
    del grads
    state.step += 1
    return state, loss


def init_train(params, cfg: DepthProConfig, device, layout: Layout | None, optimizer: AdamW,
               precision: Precision):
    """(state, step) from a one-rank param tree: copied onto ``device`` in
    fp32, cut to this rank's shard of ``layout``, as leaves that require
    grad."""
    device = resolve_device(device)
    if layout is not None and layout.mesh.size != multihost.world_size():
        raise ValueError(f"a training mesh of {layout.mesh.size} ranks in a group of "
                         f"{multihost.world_size()}: every rank trains")
    if device.type == "cuda":
        disable_tf32()
    params = map_tree(lambda t: t.detach().to(device, torch.float32), params)
    if layout is not None:
        params = shard_params(params, layout.mesh, specs=layout.specs)
    params = map_tree(lambda t: t.clone().requires_grad_(), params)
    state = TrainState(params, optimizer.init(params), 0, layout)
    return state, functools.partial(train_step, cfg=cfg, optimizer=optimizer,
                                    precision=precision)


def make_train_step(params, cfg: DepthProConfig, device="cuda", lr: float = 1e-4,
                    precision: Precision = Precision.bf16(), warmup_steps: int = 0,
                    total_steps: int | None = None, clip_norm: float | None = 1.0,
                    grad_accum: int = 1, dp: int | None = None, tp: int = 1, pp: int = 1,
                    microbatches: int = 5):
    """(state, step): the twin of the JAX package's ``make_sharded_train_step``.
    ``params`` (a tree of fp32 tensors) is copied onto ``device`` as leaves
    that require grad; ``step(state, images, depth)`` returns ``(state,
    loss)``. In a group of ranks (``parallel/multihost.py``) every rank calls
    this: the params are split by the TP rules over a (dp, tp) mesh (``dp``
    defaults to the ranks over ``tp``), or, for ``pp > 1``, along the patch
    ViT's depth over a (dp, pp) mesh (``parallel/pipeline.py``, GPipe over
    ``microbatches``); each step then takes this rank's rows of the global
    batch. ``grad_accum`` averages over that many data batches per update,
    with dp x tp too; with pp it is refused."""
    check_degrees(tp, pp, grad_accum)
    if pp > 1:
        from ..parallel.pipeline import make_pp_mesh, make_pp_train_step

        mesh = make_pp_mesh(dp or max(multihost.world_size() // pp, 1), pp)
        return make_pp_train_step(params, cfg, mesh, microbatches, lr=lr, precision=precision,
                                  warmup_steps=warmup_steps, total_steps=total_steps,
                                  clip_norm=clip_norm, device=device)
    check_heads(cfg.vit.num_heads, tp)
    mesh = make_mesh(dp=dp, tp=tp)
    layout = None
    if multihost.world_size() > 1:
        layout = Layout.build(with_groups(mesh), params, param_shardings(params, mesh, tp > 1))
    optimizer = make_optimizer(lr, warmup_steps=warmup_steps, total_steps=total_steps,
                               clip_norm=clip_norm, grad_accum=grad_accum)
    return init_train(params, cfg, device, layout, optimizer, precision)
