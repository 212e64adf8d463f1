"""Training-step measurements of the PyTorch port on one CUDA card.

Two readings, each printed beside the card's name and power limit:

1. ``--unstack``: the patch ViT of the ``large`` preset (35 x batch 2 tiles of
   384^2, bf16, per-block recompute) forward + backward to its stacked block
   params, with the port's per-block views (``models/vit.py::_unstack``, one
   ``unbind`` per leaf) against slicing each block out of the stack
   (``leaf[i]``, whose backward fills and adds a zero tensor of the whole
   stack per block); CUDA events, the two in turns;
2. ``--batches``: one training step (``train/step.py``: ``value_and_grad`` +
   AdamW) at each batch size, seconds per step after a warm-up step and the
   peak of ``torch.cuda.max_memory_allocated`` (a batch that does not fit
   prints "out of memory");
3. ``--conditioning``: ``fit`` of the ``large`` preset as ``chip_smoke.py``'s
   train phase runs it (8 written pairs, batch 2, 8 steps), then one loss +
   backward with the kernels, with the plain versions routed in (bf16), and
   with the plain versions in fp32, on every pixel and on the pixels that
   ``chip_smoke.conditioned_depth`` keeps at several relative bounds: the
   share left out, the kernels against plain and plain bf16 against fp32
   (relative L2 and cosine of the flattened gradient), overall and per
   parameter group;
4. ``--tiny``: ``chip_smoke.py``'s tiny fp32 step (raw params), the card
   against the CPU, on every pixel and on the pixels that
   ``conditioned_depth`` keeps at several bounds: the share left out, the
   loss, and per gradient leaf the elements outside rtol 1e-3 / atol 1e-4;
   and how far apart the two devices' canonical maps are.

Run on the card: ``python3 scripts/torch_train_probe.py [--unstack] [--batches 2 4 8]
[--conditioning] [--tiny]``.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from ml_depth_pro_video_tpu_torch.ckpt.params import _map_with_path, map_tree  # noqa: E402
from ml_depth_pro_video_tpu_torch.core.precision import Precision, disable_tf32  # noqa: E402
from ml_depth_pro_video_tpu_torch.models import vit as vit_module  # noqa: E402
from ml_depth_pro_video_tpu_torch.models.depth_pro import build_params, model_preset  # noqa: E402
from ml_depth_pro_video_tpu_torch.models.depth_pro import forward  # noqa: E402
from ml_depth_pro_video_tpu_torch.train import loop as loop_module  # noqa: E402
from ml_depth_pro_video_tpu_torch.train.data import DepthDataset  # noqa: E402
from ml_depth_pro_video_tpu_torch.train.step import (  # noqa: E402
    make_train_step,
    tree_leaves,
    value_and_grad,
)
from ml_depth_pro_video_tpu_torch.utils.synthetic import write_dataset  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sliced(blocks: dict, depth: int) -> list:
    """Per-block params sliced out of the stacks, one ``leaf[i]`` per block."""
    return [{k: v[i] for k, v in blocks.items()} for i in range(depth)]


def vit_backward_ms(params: dict, x: torch.Tensor, cfg, unstack) -> float:
    real = vit_module._unstack
    vit_module._unstack = unstack
    try:
        leaves = tree_leaves(params)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tokens, _ = vit_module.vit_apply(params, x, cfg, Precision.bf16(), remat=True)
        grads = torch.autograd.grad(tokens.float().square().mean(), leaves, allow_unused=True)
        end.record()
        end.synchronize()
        del grads, tokens
        return start.elapsed_time(end)
    finally:
        vit_module._unstack = real


def probe_unstack(runs: int = 4) -> None:
    cfg = model_preset("large")
    vit = map_tree(lambda t: t.requires_grad_(), build_params(cfg, "cuda", 0)["encoder"]["patch_vit"])
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((35 * 2, 384, 384, 3), generator=g, device="cuda").bfloat16()
    times = {"unbind": [], "slice": []}
    order = (("unbind", vit_module._unstack), ("slice", sliced))
    for _, fn in order:
        vit_backward_ms(vit, x, cfg.vit, fn)  # warm-up
    for i in range(runs):
        for name, fn in order if i % 2 == 0 else order[::-1]:
            times[name].append(vit_backward_ms(vit, x, cfg.vit, fn))
    print(f"[unstack] patch ViT (70 x 384^2, bf16, remat) forward + backward, median of {runs} "
          f"(ms): unbind {statistics.median(times['unbind']):.3f} {times['unbind']}; per-block "
          f"slice {statistics.median(times['slice']):.3f} {times['slice']} on {card()}",
          flush=True)


def probe_batches(batches: list) -> None:
    cfg = model_preset("large")
    for b in batches:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            state, step = make_train_step(build_params(cfg, "cuda", 0), cfg, "cuda",
                                          warmup_steps=1, total_steps=10)
            g = torch.Generator(device="cuda").manual_seed(2)
            x = torch.rand((b, cfg.img_size, cfg.img_size, 3), generator=g, device="cuda") * 2 - 1
            d = torch.rand((b, cfg.img_size, cfg.img_size), generator=g, device="cuda") * 9 + 1
            secs = []
            for _ in range(3):  # the first is the warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, x, d)
                float(loss)
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            print(f"[batches] batch {b}: s/step {secs[1:]} (first {secs[0]:.3f}), "
                  f"{b / statistics.mean(secs[1:]):.3f} samples/s, peak {peak} bytes "
                  f"({peak / 2**30:.2f} GiB) on {card()}", flush=True)
            del state, step, x, d
        except torch.cuda.OutOfMemoryError:
            print(f"[batches] batch {b}: out of memory on {card()}", flush=True)
        torch.cuda.empty_cache()


def groups(params: dict) -> list[str]:
    """Each leaf's parameter group (the first two keys of its path), in
    ``tree_leaves`` order."""
    out: list = []
    _map_with_path(lambda path, _: out.append("/".join(path[:2])), params)
    return out


def probe_conditioning(rels=(0.1, 5e-2, 2e-2, 1e-2)) -> None:
    data = chip_smoke.TRAIN_DIR / "probe_data"
    write_dataset(str(data), chip_smoke.TRAIN_PAIRS, seed=chip_smoke.SEED, size=512)
    cfg = model_preset("large")
    state = loop_module.fit(str(data), cfg, batch_size=chip_smoke.BATCH, epochs=2, lr=1e-4,
                            warmup_steps=1, seed=chip_smoke.SEED, log_every=1, device="cuda")
    images, depth = next(DepthDataset(str(data), cfg.img_size, seed=chip_smoke.SEED).batches(
        chip_smoke.BATCH, device="cuda"))
    names = groups(state.params)
    maps = []
    for precision, plain in chip_smoke.TRAIN_RUNS.values():
        with chip_smoke.routed(plain), torch.no_grad():
            c, _ = forward(state.params, images, cfg, precision, compute_fov=False)
        maps.append(c[..., 0].float())
    low = torch.stack(maps).amin(0)
    print(f"[conditioning] fit to step {state.step}; canonical inverse depth of the kernels' run: "
          f"max {float(maps[0].max()):.4e}, share at or below the clamp "
          f"{float((low <= chip_smoke.SILOG_EPS).float().mean()):.6f}, below 1e-3 "
          f"{float((low <= 1e-3).float().mean()):.6f}", flush=True)
    for rel in (None, *rels):
        target, left_out = (depth, 0.0) if rel is None else chip_smoke.conditioned_depth(
            depth, maps, rel)
        out = {}
        for name, (precision, plain) in chip_smoke.TRAIN_RUNS.items():
            with chip_smoke.routed(plain):
                loss, grads = value_and_grad(state.params, images, target, cfg, precision)
            out[name] = (float(loss), grads)
        (lk, gk), (lp, gp), (lf, gf) = out.values()
        row = {"all": (chip_smoke.grad_agreement(gk, gp), chip_smoke.grad_agreement(gp, gf))}
        for g in dict.fromkeys(names):
            pick = lambda gs, g=g: [x for x, n in zip(gs, names) if n == g]  # noqa: E731
            if any(x is not None for x in pick(gp)):
                row[g] = (chip_smoke.grad_agreement(pick(gk), pick(gp)),
                          chip_smoke.grad_agreement(pick(gp), pick(gf)))
        del out, gk, gp, gf
        cells = "; ".join(f"{g} {k[0]:.3e} / {k[1]:.6f} vs {e[0]:.3e} / {e[1]:.6f}"
                          for g, (k, e) in row.items())
        print(f"[conditioning] {'every pixel' if rel is None else f'rel {rel:g}'}: "
              f"{left_out:.6f} of pixels left out; losses kernels {lk:.6f} plain {lp:.6f} fp32 "
              f"{lf:.6f}; relative L2 / cosine, kernels against plain vs plain bf16 against "
              f"fp32: {cells} on {card()}", flush=True)


def probe_tiny(rels=(1e-3, 3e-4, 1e-4, 3e-5, 1e-5)) -> None:
    cfg, images, depth, params = chip_smoke.tiny_case()
    maps = chip_smoke.tiny_maps(cfg, images, params)
    on_cpu, on_card = maps
    low = torch.minimum(on_cpu, on_card)
    rel = ((on_card - on_cpu).abs() / low)[low > chip_smoke.SILOG_EPS]
    q = torch.quantile(rel[::7].double(), torch.tensor([0.5, 0.99, 0.9999], dtype=torch.float64))
    print(f"[tiny] canonical maps, card against CPU (fp32): max |diff| "
          f"{float((on_card - on_cpu).abs().max()):.3e}, max {float(on_cpu.max()):.4e}; relative "
          f"to the "
          f"value above the clamp: median {q[0]:.3e}, p99 {q[1]:.3e}, p99.99 {q[2]:.3e}, max "
          f"{float(rel.max()):.3e}; at or below the clamp {float((low <= 1e-6).float().mean()):.6f}",
          flush=True)
    for r in (None, *rels):
        target, left_out = (depth, 0.0) if r is None else chip_smoke.conditioned_depth(
            depth, maps, r)
        out = chip_smoke.tiny_steps(cfg, images, target, params)
        (lc, gc, _, _), (lg, gg, _, _) = out["cpu"], out["cuda"]
        bad, worst, names = 0, 0.0, []
        for path_leaf, a, b in zip(_leaf_paths(params["cpu"]), gg, gc):
            if a is None:
                continue
            n = int((((a - b).abs()) > chip_smoke.TINY_GRAD_ATOL
                     + chip_smoke.TINY_GRAD_RTOL * b.abs()).sum())
            bad += n
            worst = max(worst, float((a - b).abs().max()))
            if n:
                names.append(f"{path_leaf} {n}/{a.numel()}")
        l2, cos = chip_smoke.grad_agreement(gg, gc)
        print(f"[tiny] {'every pixel' if r is None else f'bound {r:g}'}: {left_out:.6f} of pixels "
              f"left out; loss {lg:.7f} / {lc:.7f}; relative L2 {l2:.3e}, cosine {cos:.9f}; "
              f"elements outside rtol 1e-3 / atol 1e-4: {bad} (max |diff| {worst:.3e}) "
              f"{names[:4]} on {card()}", flush=True)


def _leaf_paths(params: dict) -> list[str]:
    out: list = []
    _map_with_path(lambda path, _: out.append("/".join(path)), params)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unstack", action="store_true")
    ap.add_argument("--batches", type=int, nargs="*", default=[])
    ap.add_argument("--conditioning", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_probe: no CUDA device")
    disable_tf32()
    if args.unstack:
        probe_unstack()
    if args.batches:
        probe_batches(args.batches)
    if args.conditioning:
        probe_conditioning()
    if args.tiny:
        probe_tiny()
    return 0


if __name__ == "__main__":
    sys.exit(main())
