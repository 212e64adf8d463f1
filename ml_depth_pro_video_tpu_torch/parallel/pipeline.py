"""GPipe pipeline parallelism (pp) for the patch ViT (twin of ``ml_depth_pro_video_tpu/parallel/pipeline.py``).

The patch ViT's stacked blocks are split along depth over the ``pp`` axis
of a (dp, pp) mesh: each stage (rank) holds ``depth / pp`` blocks and their
AdamW moments, and the (N, S, D) tokens stream through the stages in ``M =
microbatches`` microbatches of (N / M, S, D), one activation per
microbatch to the next stage and its gradient back, point to point
(``multihost.transfer``). The DPT hook captures (blocks
``cfg.hook_block_ids``) are banked by the stage that owns the block; the
last stage banks the trunk's output; each bank is then broadcast over the
stages (the JAX package sums zero-filled buffers with ``psum``). The patch
embed, the final norm, the image ViT, the decoder, the head and the loss
run replicated on every stage.

The JAX package runs the schedule as a ``lax.scan`` over ``M + pp - 1``
ticks inside ``shard_map`` and lets ``jax.grad`` transpose it. Here the
schedule is explicit, so no rank's autograd engine chooses the order of a
cross-stage receive (two neighbours that walk their graphs in different
orders would deadlock):

1. forward, microbatch by microbatch: stage 0 takes its microbatch of the
   embedded tokens, every other stage receives it from the previous stage;
   each stage keeps its microbatch's input (a leaf that requires grad), its
   output and its captures (each block recomputed in the backward pass);
2. the banks broadcast to every stage as leaves; the replicated tail and
   the loss; the tail's gradients, the same on every stage, and the banks';
3. the microbatches backward in a fixed order (the last first): each stage
   receives its output's gradient from the next stage (the last stage takes
   the bank's), adds its captures' and sends its input's gradient to the
   previous stage;
4. stage 0 backpropagates the tokens' gradient through the patch embed,
   whose gradient is then summed over the stages (zeros elsewhere).

So each replicated param's gradient is counted once: the tail's is computed
identically on every stage, the embed's by stage 0 alone. The GPipe bubble
ticks, where the JAX scan runs stale state for its fixed shape, are not
computed.

Exact path only: the ToMe merge tier changes the token count mid-trunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.precision import Precision
from ..models.vit import ViTConfig, _run_blocks, _unstack, embed_tokens
from ..ops.norm import layer_norm
from . import multihost
from .mesh import AxisGroup, Mesh, with_groups
from .sharding import Layout, shard_params

# the patch ViT's params that only stage 0 reaches (through the tokens it feeds the pipeline)
EMBED = ("patch_embed", "cls_token", "pos_embed")


def make_pp_mesh(dp: int = 1, pp: int = 2, ranks=None) -> Mesh:
    """A (dp, pp) mesh over ``ranks`` (every rank of the group by default);
    pp is the pipeline-stage axis."""
    ranks = list(range(multihost.world_size())) if ranks is None else [int(r) for r in ranks]
    if dp * pp > len(ranks) or dp < 1 or pp < 1:
        raise ValueError(f"mesh {dp}x{pp} needs {dp * pp} devices, have {len(ranks)}")
    return Mesh(np.asarray(ranks[:dp * pp]).reshape(dp, pp), ("dp", "pp"))


def _peer(group: AxisGroup, step: int):
    """The rank ``step`` stages after this one on ``group``, None past either end."""
    s = group.index + step
    return group.ranks[s] if 0 <= s < group.size else None


class GPipe:
    """What :func:`pipeline_blocks` keeps of one forward for the backward
    across stages (:meth:`backward`): each microbatch's stage input, output
    and captures, and the schedule's shape."""

    def __init__(self):
        self.steps: list = []

    def backward(self, out_grad: torch.Tensor, capture_grads: list, leaves: list):
        """The trunk's backward from the banks' gradients: (the gradients of
        ``leaves``, this stage's block params, summed over the microbatches;
        on stage 0 the tokens' gradient, else None)."""
        prev, nxt = _peer(self.group, -1), _peer(self.group, 1)
        mb = self.mb
        acc: list = [None] * len(leaves)
        token_grads = [None] * len(self.steps)
        for m in reversed(range(len(self.steps))):
            x, y, caps = self.steps[m]
            if nxt is None:
                gy = out_grad[m * mb:(m + 1) * mb]
            else:
                gy = multihost.transfer({}, {nxt: y})[nxt]
            roots = [y, *caps]
            seeds = [gy, *(capture_grads[j][m * mb:(m + 1) * mb] for j, _ in self.mine)]
            got = torch.autograd.grad(roots, [x, *leaves], seeds, allow_unused=True)
            if prev is not None:
                multihost.transfer({prev: got[0]}, {})
            else:
                token_grads[m] = got[0]
            acc = [a if g is None else (g if a is None else a + g) for a, g in zip(acc, got[1:])]
            self.steps[m] = None
        return acc, None if prev is not None else torch.cat(token_grads)


def pipeline_blocks(tokens: torch.Tensor, blocks_local: dict, cfg: ViTConfig, *,
                    group: AxisGroup, microbatches: int, capture_blocks=(),
                    remat: bool = False, schedule: GPipe | None = None):
    """Run the block trunk as a GPipe pipeline over ``group`` (this rank's pp
    line; every stage calls this with the same shapes). tokens: (N, S, D),
    the same on every stage (only stage 0's are read); ``blocks_local`` this
    stage's slice (leading axis ``depth // pp``) of the stacked block params.
    Returns ``(out (N, S, D), [captures (N, S, D)])`` on every stage. With
    grad enabled and a ``schedule``, what :meth:`GPipe.backward` needs is
    kept on it and the results are leaves that require grad."""
    n, s, d = tokens.shape
    if n % microbatches:
        raise ValueError(f"microbatches {microbatches} must divide batch {n}")
    mb = n // microbatches
    l_local = blocks_local["ln1_g"].shape[0]
    for c in capture_blocks:
        if not 0 <= c < group.size * l_local:
            raise ValueError(f"capture block {c} out of range")
    owners = [c // l_local for c in capture_blocks]
    mine = [(j, c % l_local) for j, c in enumerate(capture_blocks) if owners[j] == group.index]
    grad = torch.is_grad_enabled() and schedule is not None
    prev, nxt = _peer(group, -1), _peer(group, 1)
    like = tokens[:mb]
    outs, banked, steps = [], {j: [] for j, _ in mine}, []
    for m in range(microbatches):
        if prev is None:
            x = tokens[m * mb:(m + 1) * mb].detach()
        else:
            x = multihost.transfer({}, {prev: like})[prev]
        if grad:
            x.requires_grad_()
        # a fresh unbind per microbatch: each microbatch's graph is its own
        layers = _unstack(blocks_local, l_local)
        y, ys = x, []
        for i in range(l_local):
            y = _run_blocks(y, layers, i, i + 1, cfg, remat=remat)
            ys.append(y)
        if nxt is not None:
            multihost.transfer({nxt: y.detach()}, {})
        else:
            outs.append(y.detach())
        caps = [ys[cl] for _, cl in mine]
        for (j, _), c in zip(mine, caps):
            banked[j].append(c.detach())
        if grad:
            steps.append((x, y, caps))
    # the banks from their owners to every stage
    out = multihost.broadcast(torch.cat(outs) if nxt is None else tokens.new_empty((n, s, d)),
                              group.ranks[-1], group.group)
    captures = [multihost.broadcast(torch.cat(banked[j]) if owners[j] == group.index
                                    else tokens.new_empty((n, s, d)),
                                    group.ranks[owners[j]], group.group)
                for j in range(len(capture_blocks))]
    if grad:
        schedule.group, schedule.mine, schedule.mb, schedule.steps = group, mine, mb, steps
        out.requires_grad_()
        for c in captures:
            c.requires_grad_()
    return out, captures


def pp_vit_apply(params: dict, x: torch.Tensor, cfg: ViTConfig, precision: Precision, *,
                 group: AxisGroup, microbatches: int, capture_blocks=(), remat: bool = False,
                 pipe: GPipe | None = None):
    """``models.vit.vit_apply`` with the trunk pipelined over ``group`` by
    :func:`pipeline_blocks` (``params['blocks']`` holds this stage's depth
    slice): the embed, run on every stage, feeds stage 0; the final norm runs
    replicated on the banked output. With ``pipe``, the embedded tokens and
    the banks are kept on it too (``tokens``, ``banks``) for the training
    step's backward."""
    tokens = embed_tokens(params, x, cfg, precision)
    out, captures = pipeline_blocks(tokens, params["blocks"], cfg, group=group,
                                    microbatches=microbatches, capture_blocks=capture_blocks,
                                    remat=remat, schedule=pipe)
    if pipe is not None:
        pipe.tokens, pipe.banks = tokens, [out, *captures]
    out = layer_norm(out, params["norm"]["g"], params["norm"]["b"], cfg.layer_norm_eps)
    return out, captures


def _param_specs(params: dict):
    """The spec tree: the patch ViT's stacked blocks split over pp along
    depth, everything else replicated."""
    def specs(tree, spec):
        if isinstance(tree, dict):
            return {k: specs(v, spec) for k, v in tree.items()}
        if isinstance(tree, list):
            return [specs(v, spec) for v in tree]
        return None if tree is None else spec

    out = specs(params, ())
    out["encoder"]["patch_vit"]["blocks"] = specs(params["encoder"]["patch_vit"]["blocks"],
                                                  ("pp",))
    return out


def shard_pp_params(params: dict, mesh: Mesh) -> dict:
    """This rank's params on a (dp, pp) mesh with groups: its stage's slice of
    the patch ViT's blocks, the rest whole."""
    return shard_params(params, mesh, specs=_param_specs(params))


def pp_patch_vit_fn(cfg, precision: Precision, layout: Layout, remat: bool = False):
    """A ``forward(patch_vit_fn=)`` hook that pipelines the patch ViT over the
    layout's pp line; the hook's ``pipe`` attribute is the schedule."""
    pipe = GPipe()

    def patch_vit_fn(vp, pyramid):
        tokens, captures = pp_vit_apply(vp, pyramid, cfg.vit, precision,
                                        group=layout.mesh.group("pp"),
                                        microbatches=layout.microbatches,
                                        capture_blocks=cfg.hook_block_ids, remat=remat, pipe=pipe)
        return tokens, tuple(captures)

    patch_vit_fn.pipe = pipe
    return patch_vit_fn


def pp_value_and_grad(params, images, target_depth, cfg, precision: Precision,
                      layout: Layout):
    """(the loss of the global batch, this rank's gradients before the dp
    sum) of a (dp, pp) layout: the schedule of the module docstring."""
    from ..models.depth_pro import forward
    from ..train.step import global_silog, tree_leaves

    leaves = tree_leaves(params)
    vit = params["encoder"]["patch_vit"]
    trunk_ids = {id(t) for t in tree_leaves(vit["blocks"])}
    embed_ids = {id(t) for k in EMBED for t in tree_leaves(vit[k])}
    trunk = [i for i, t in enumerate(leaves) if id(t) in trunk_ids]
    embed = [i for i, t in enumerate(leaves) if id(t) in embed_ids]

    fn = pp_patch_vit_fn(cfg, precision, layout, remat=True)
    canonical, _ = forward(params, images, cfg, precision, compute_fov=False, remat=True,
                           patch_vit_fn=fn)
    pipe = fn.pipe
    loss, share = global_silog(canonical[..., 0].float(), target_depth, layout.group("dp"))
    del canonical
    got = torch.autograd.grad(share, leaves + pipe.banks, allow_unused=True)
    grads, bank_grads = list(got[:len(leaves)]), got[len(leaves):]
    bank_grads = [torch.zeros_like(b) if g is None else g for b, g in zip(pipe.banks, bank_grads)]
    del got, share
    trunk_grads, token_grad = pipe.backward(bank_grads[0], bank_grads[1:],
                                            [leaves[i] for i in trunk])
    for i, g in zip(trunk, trunk_grads):
        grads[i] = g
    if token_grad is not None:
        embed_grads = torch.autograd.grad(pipe.tokens, [leaves[i] for i in embed], token_grad)
    else:
        embed_grads = [torch.zeros_like(leaves[i]) for i in embed]
    group = layout.group("pp")
    for i, g in zip(embed, embed_grads):
        grads[i] = multihost.all_reduce(g, group)
    return loss, grads


def make_pp_train_step(params: dict, cfg, mesh: Mesh, microbatches: int = 5, lr: float = 1e-4,
                       precision: Precision = Precision.bf16(), warmup_steps: int = 0,
                       total_steps: int | None = None, clip_norm: float | None = 1.0,
                       device="cuda"):
    """``(state, step)`` with the patch ViT's trunk pipeline-parallel over the
    mesh's pp axis and the batch split over dp; the step's signature is
    ``train.step.make_train_step``'s: ``step(state, images, depth) ->
    (state, loss)``, ``images`` and ``depth`` this rank's rows of the global
    batch. ``cfg.vit.depth`` must divide by pp, and ``microbatches`` 35 x
    the rows (checked at the step); the merge tier is refused."""
    from ..train.step import init_train, make_optimizer

    if cfg.token_merge_ratio > 0:
        raise ValueError("pipeline parallelism requires the exact path "
                         "(token_merge_ratio == 0)")
    pp = mesh.shape["pp"]
    if cfg.vit.depth % pp:
        raise ValueError(f"ViT depth {cfg.vit.depth} not divisible by pp={pp}")
    optimizer = make_optimizer(lr, warmup_steps=warmup_steps, total_steps=total_steps,
                               clip_norm=clip_norm)
    layout = Layout.build(with_groups(mesh), params, _param_specs(params), microbatches)
    return init_train(params, cfg, device, layout, optimizer, precision)
