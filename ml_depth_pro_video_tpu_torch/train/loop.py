"""End-to-end fine-tuning loop: data -> step -> checkpoints.

Twin of ``ml_depth_pro_video_tpu/train/loop.py``: the ``DepthDataset``
host feed, ``make_train_step`` (AdamW, clipping, schedule, gradient
accumulation; DP x TP, or GPipe over ``pp``), ``torch.save`` checkpointing
with resume, and periodic validation on a held-out slice. Across ranks (one
process per device, ``parallel/multihost.py``) the same ``fit`` runs on
every rank: each decodes its rows of every global batch, metrics and
checkpoints are written by rank 0, and validation runs on every rank in
lock-step.

Library entry: ``fit(...)``. CLI: ``depth-pro-train-torch`` /
``python -m ml_depth_pro_video_tpu_torch.train.loop``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from ..ckpt.checkpointing import restore_train_state, save_train_state
from ..core.precision import Precision, resolve_device
from ..models.depth_pro import DEFAULT_MONODEPTH_CONFIG, DepthProConfig, build_params
from ..parallel import multihost
from ..parallel.mesh import batch_sharding, make_mesh, round_batch_to_dp
from .data import DepthDataset
from .step import TrainState, check_degrees, loss_fn, make_train_step

log = logging.getLogger(__name__)

def fit(
    data_root: str,
    cfg: DepthProConfig = DEFAULT_MONODEPTH_CONFIG,
    batch_size: int = 8,
    epochs: int = 1,
    lr: float = 1e-4,
    warmup_steps: int = 100,
    clip_norm: float = 1.0,
    tp: int = 1,
    precision: Precision | None = None,
    checkpoint_dir: str | None = None,
    save_every: int = 500,
    holdout: int = 0,
    log_every: int = 10,
    seed: int = 0,
    dp: int | None = None,
    pp: int = 1,
    microbatches: int = 5,
    metrics_file: str | None = None,
    grad_accum: int = 1,
    device="cuda",
):
    """Fine-tune Depth Pro on a directory of (image, depth) pairs, on
    ``device`` (the card unless the caller asks for the CPU).

    Returns the final ``TrainState``. ``holdout`` reserves that many pairs
    for validation (SILog on the canonical head, reported at every
    checkpoint). Resumes from ``checkpoint_dir`` when it has a step, skipping
    the batches already trained without decoding them. ``pp > 1`` pipelines
    the patch ViT's depth GPipe-style over a (dp, pp) mesh
    (``parallel/pipeline.py``) instead of DP x TP; ``microbatches`` sets the
    pipeline's microbatch count (must divide 35 x batch/dp; the default 5
    always does). ``grad_accum > 1`` averages gradients over that many data
    batches per parameter update (effective batch = ``batch_size x
    grad_accum`` at the memory of one batch; DP x TP path only: the GPipe
    path already microbatches).

    Across ranks: after ``parallel.multihost.initialize()`` this same
    function runs on every rank; the mesh covers them all, each rank decodes
    only its rows of every (seeded, identical) shuffled batch, and one
    checkpoint in the one-rank layout is written by rank 0 (a resume
    re-shards it). ``batch_size`` is the GLOBAL batch, rounded up to a
    multiple of dp. Requires a shared data and checkpoint filesystem.

    ``metrics_file`` appends one JSON line per logged step (``{"step",
    "loss", "lr_progress", "s_per_step"}``; validation rounds add
    ``{"step", "val_silog"}``); rank 0 only; the file appends across resumes
    (the step field orders everything).
    """
    precision = precision or Precision.bf16()
    check_degrees(tp, pp, grad_accum)  # before the data is read
    device = resolve_device(device)
    world = multihost.world_size()
    if pp > 1:
        from ..parallel.pipeline import make_pp_mesh

        if pp > world:
            raise ValueError(f"pp={pp} needs at least {pp} devices, have {world}")
        # dp=0 would build an empty mesh; max(..., 1) keeps pp == world meaning dp=1
        mesh = make_pp_mesh(dp=dp or max(world // pp, 1), pp=pp)
    else:
        mesh = make_mesh(dp=dp, tp=tp)
    batch_size = round_batch_to_dp(batch_size, mesh)

    dataset = DepthDataset(data_root, cfg.img_size, seed=seed)
    val_pairs = dataset.pairs[:holdout]
    dataset.pairs = dataset.pairs[holdout:]
    steps_per_epoch = len(dataset) // batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"{len(dataset)} training pairs (after holdout={holdout}) is fewer "
            f"than batch_size={batch_size}: no full batch to train on"
        )
    total_steps = steps_per_epoch * epochs

    # the checkpoint's params when cfg.checkpoint_uri exists, else random
    # ones from the seed (with a warning)
    state, step_fn = make_train_step(
        build_params(cfg, device, seed), cfg, device, lr=lr, precision=precision,
        warmup_steps=warmup_steps, total_steps=total_steps, clip_norm=clip_norm,
        grad_accum=grad_accum, dp=mesh.shape["dp"], tp=tp, pp=pp, microbatches=microbatches)
    layout = state.layout
    if checkpoint_dir:
        # a sharded run reads the one-rank state onto the host and cuts its shard there
        restored = restore_train_state(checkpoint_dir, device=device if layout is None else "cpu")
        if restored is not None:
            state = TrainState.from_dict(restored, layout, device)
            log.info("resumed from %s at step %d", checkpoint_dir, state.step)

    batch_kw = {}
    if world > 1:
        rows = multihost.local_rows(batch_sharding(mesh), (batch_size,))
        batch_kw = dict(local_rows=rows, assemble=lambda a: a)  # each rank keeps its rows
        log.info("fit over %d ranks: rank %d decodes %d/%d batch rows", world,
                 multihost.rank(), len(rows), batch_size)
    start = state.step
    losses: list[float] = []
    last_val_step = -1
    t0 = time.perf_counter()

    def emit_metrics(record: dict) -> None:
        if metrics_file is None or not multihost.is_primary():
            return
        try:
            with open(metrics_file, "a") as f:
                json.dump(record, f)
                f.write("\n")
        except OSError as exc:
            log.warning("could not append %s: %s", metrics_file, exc)

    # resume: skip already-trained batches without decoding them; the
    # shuffle permutations are still consumed, so the stream position
    # matches the saved step deterministically
    for images, depth in dataset.batches(batch_size, epochs=epochs, skip=start, device=device,
                                         **batch_kw):
        state, loss = step_fn(state, images, depth)
        losses.append(float(loss))
        step = state.step
        if step % log_every == 0:
            dt = (time.perf_counter() - t0) / max(len(losses), 1)
            mean_loss = float(np.mean(losses[-log_every:]))
            log.info("step %d/%d loss %.4f (%.2f s/step)", step, total_steps, mean_loss, dt)
            emit_metrics({"step": step, "loss": mean_loss,
                          "lr_progress": step / max(total_steps, 1),
                          "s_per_step": round(dt, 4)})
        if checkpoint_dir and step % save_every == 0:
            save_train_state(checkpoint_dir, state.to_dict(), state.step)
            if val_pairs:
                v = _validate(state.params, val_pairs, cfg, precision, batch_size, device,
                              layout)
                log.info("step %d val_silog %.4f", step, v)
                emit_metrics({"step": step, "val_silog": v})
                last_val_step = step
    if checkpoint_dir:
        save_train_state(checkpoint_dir, state.to_dict(), state.step)
    # skip the final validation when the last checkpoint round already
    # validated this exact step
    if val_pairs and last_val_step != state.step:
        v = _validate(state.params, val_pairs, cfg, precision, batch_size, device, layout)
        log.info("final val_silog %.4f", v)
        emit_metrics({"step": state.step, "val_silog": v})
    return state


@torch.no_grad()
def _validate(params, pairs, cfg, precision, batch_size, device="cuda", layout=None) -> float:
    """Mean SILog over the held-out pairs, the training loss function
    without gradients. Unreadable pairs are zero-substituted (batch
    composition stays deterministic), and a batch with no valid pixel, whose
    SILog is an exact 0.0, is left out of the mean: averaging it in would
    pull val_silog optimistically toward 0. Across ranks (``layout``: the
    params are this rank's shard) every rank computes every pair
    (replicated), in lock-step: the loss is called for
    every batch whatever its pixels, so a rank whose decode failed still
    takes part in each collective of the forward."""
    ds = DepthDataset.__new__(DepthDataset)
    ds.image_size = cfg.img_size
    ds.pairs = pairs
    ds.rng = np.random.default_rng(0)
    vals = []
    for images, depth in ds.batches(batch_size, epochs=1, device=device,
                                    drop_remainder=False, zero_substitute=True):
        v = loss_fn(params, images, depth, cfg, precision, layout)
        if bool((depth > 0).any()):
            vals.append(float(v))
    return float(np.mean(vals)) if vals else float("nan")


def main(argv=None) -> None:
    from ..models.depth_pro import MODEL_PRESETS, model_preset

    ap = argparse.ArgumentParser(description="Fine-tune Depth Pro (PyTorch/CUDA port, DP x TP "
                                             "or GPipe over ranks)")
    ap.add_argument("--data_root", required=True,
                    help="directory of image + <stem>_depth.npy pairs")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup_steps", type=int, default=100)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel degree (GPipe over the patch ViT's depth; "
                         "exclusive with --tp)")
    ap.add_argument("--microbatches", type=int, default=5,
                    help="GPipe microbatch count (pp > 1)")
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="average gradients over this many data batches per parameter update "
                         "(effective batch = batch_size x grad_accum; memory of one batch)")
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--holdout", type=int, default=0)
    ap.add_argument("--metrics_file", default=None,
                    help="append one JSON line per logged step (loss/val_silog/s_per_step); "
                         "rank 0 only")
    ap.add_argument("--log_every", type=int, default=10,
                    help="steps between loss log lines / metrics rows")
    ap.add_argument("--tiny", action="store_true",
                    help="miniature model config (smoke tests / CI)")
    ap.add_argument("--model", choices=list(MODEL_PRESETS), default="large",
                    help="model family member to train (models/depth_pro.py::model_preset)")
    ap.add_argument("--device", default="cuda",
                    help="device to train on: cuda (default) or cpu")
    multihost.add_multihost_args(ap)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    multihost.initialize_from_args(args)  # before any device use (no-op single-process)
    cfg = model_preset("tiny" if args.tiny else args.model)
    fit(args.data_root, cfg, batch_size=args.batch_size, epochs=args.epochs,
        lr=args.lr, warmup_steps=args.warmup_steps, tp=args.tp,
        checkpoint_dir=args.checkpoint_dir, save_every=args.save_every,
        holdout=args.holdout, pp=args.pp, microbatches=args.microbatches,
        metrics_file=args.metrics_file, log_every=args.log_every,
        grad_accum=args.grad_accum, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    main()
