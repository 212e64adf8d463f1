"""Ahead-of-time export of the runner's inference program
(``depth-pro-export-torch``).

Twin of ``ml_depth_pro_video_tpu/ckpt/export.py``, on ``torch.export``. The
artifact is the video runner's hot program, ``fn(params, frames_uint8) ->
{"depth", "focallength_px"}`` at a FIXED (batch, img_size, img_size, 3)
uint8 input, normalised inside the program and f_px derived by the FOV
head (``video/runner.py::_infer``). The kernels are custom operators
(``ops/attention.py``, ``ops/resblock.py``), so the graph names them as
``depth_pro::*`` nodes and runs the same hand-written kernels as eager code.

What carries over from the JAX contract:

- weights are an argument, not baked in (the artifact's ``state_dict`` is
  empty): one artifact serves every checkpoint of the architecture, as the
  runner's param tree (``DepthProModel(...).tree()``, head folded; the int8
  tree of ``ckpt/quantize.py`` with ``quantize=True``);
- the validated program is pinned: shapes, dtypes and the device type it
  was traced on (tensors the program creates live there), and a sidecar
  manifest ``path + ".json"`` with the model's identity, checked at load.

What does not: JAX's artifact skips a per-process XLA compile. Eager
PyTorch has none to skip, so loading the artifact does not shorten a cold
start; the serialised program is what a later AOTInductor package would
compile.
"""

from __future__ import annotations

import json
import logging
import os

import torch
from torch import nn

# the custom operators must be registered before an artifact naming them loads
from ..ops import attention as _attention  # noqa: F401
from ..ops import resblock as _resblock  # noqa: F401
from ..core.precision import Precision, disable_tf32, resolve_device, resolve_precision
from ..models.depth_pro import DepthProConfig, DepthProModel, infer_fn
from .params import init_depth_pro, map_tree
from .quantize import quantize_vit_weights

LOGGER = logging.getLogger(__name__)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


class RunnerProgram(nn.Module):
    """The runner's single-device batch program, without parameters of its
    own: uint8 frames in, normalisation on the device, f_px derived."""

    def __init__(self, cfg: DepthProConfig, precision: Precision):
        super().__init__()
        self.cfg = cfg
        self.precision = precision

    def forward(self, params: dict, frames: torch.Tensor) -> dict:
        return infer_fn(params, frames.float() / 127.5 - 1.0, None, self.cfg, self.precision)


def example_params(cfg: DepthProConfig, quantize: bool = False, device="cuda") -> dict:
    """The runner's param tree (the int8 ViTs with ``quantize``, the head
    folded, in ``DepthProModel.tree()``'s key order) as uninitialised tensors
    on ``device``: the export reads only shapes and dtypes."""
    device = resolve_device(device)
    tree = init_depth_pro(cfg, torch.Generator().manual_seed(0), "meta")
    if quantize:
        tree = quantize_vit_weights(tree)
    tree = DepthProModel(tree, cfg).tree()
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def export_infer(cfg: DepthProConfig, precision="bf16", batch_size: int = 1,
                 path: str | None = None, quantize: bool = False,
                 device="cuda", dp: int = 1) -> torch.export.ExportedProgram:
    """Export the inference program for ``batch_size`` uint8 frames at the
    model's native resolution on ``device`` (the card unless the caller
    asks for the CPU; an artifact serves only runners of that device type);
    write it (``torch.export.save``)
    and its manifest to ``path`` when given. ``quantize`` exports the
    int8-weight program (its params take the ``ckpt/quantize.py`` tree).

    ``dp > 1`` exports the data-parallel program of ``dp`` ranks: the
    per-rank program at ``batch_size / dp`` frames, which each rank of a
    runner with a dp mesh of ``dp`` ranks runs on its rows
    (``parallel/spmd.py``). The manifest pins the rank count."""
    if dp < 1 or batch_size % dp:
        raise ValueError(f"batch_size {batch_size} must be a multiple of the mesh's dp={dp} "
                         "(each rank takes batch/dp frames)")
    precision = resolve_precision(precision)
    device = resolve_device(device)
    params = example_params(cfg, quantize, device)
    frames = torch.empty((batch_size // dp, cfg.img_size, cfg.img_size, 3), dtype=torch.uint8,
                         device=device)
    with torch.no_grad():
        exported = torch.export.export(RunnerProgram(cfg, precision), (params, frames),
                                       strict=False)
    # the example inputs are uninitialised weights: an artifact holds none
    exported.example_inputs = None
    if path is not None:
        torch.export.save(exported, path)
        # the artifact carries no model identity: a program exported for
        # another merge ratio, precision or family member would serve
        # silently wrong depth, so the loader checks this manifest
        with open(path + ".json", "w") as f:
            json.dump({
                "img_size": cfg.img_size,
                "batch_size": batch_size,
                "vit_embed_dim": cfg.vit.embed_dim,
                "vit_depth": cfg.vit.depth,
                "compute_dtype": _DTYPE_NAMES[precision.compute_dtype],
                "token_merge_ratio": cfg.token_merge_ratio,
                "token_merge_block": cfg.token_merge_block,
                "quantized": quantize,
                "platforms": [device.type],
                "nr_devices": dp,
            }, f, indent=1)
        LOGGER.info("exported %s (%d bytes, platform %s, batch %d, %dpx)", path,
                    os.path.getsize(path), device.type, batch_size, cfg.img_size)
    return exported


def user_inputs(exported: torch.export.ExportedProgram) -> list:
    """The fake tensors of the program's user inputs, in order: the param
    tree's leaves, then the frames."""
    names = set(exported.graph_signature.user_inputs)
    return [n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in names]


def load_exported(path: str, cfg: DepthProConfig | None = None, precision=None,
                  quantize: bool | None = None, n_devices: int | None = None,
                  device=None) -> torch.export.ExportedProgram:
    """Load an artifact of :func:`export_infer`; call ``exported.module()(params,
    frames_uint8)``. With ``cfg`` / ``precision`` / ``quantize`` and a
    manifest, a mismatched model identity raises; ``device`` must be of the
    device type the program was traced on; ``n_devices`` (1, or the ranks of
    a dp-mesh runner) must be the count the manifest pins. The weight
    format is read from the artifact itself, so it is checked without a
    manifest too."""
    manifest_path = path + ".json"
    platform = None if device is None else torch.device(device).type
    nr_devices = None
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            m = json.load(f)
        nr_devices = m.get("nr_devices", 1)
        want = {}
        if cfg is not None:
            want.update(img_size=cfg.img_size, token_merge_ratio=cfg.token_merge_ratio,
                        token_merge_block=cfg.token_merge_block,
                        vit_embed_dim=cfg.vit.embed_dim, vit_depth=cfg.vit.depth)
        if precision is not None:
            want["compute_dtype"] = _DTYPE_NAMES[resolve_precision(precision).compute_dtype]
        if quantize is not None:
            want["quantized"] = bool(quantize)
        if platform is not None:
            want["platforms"] = [platform]
        bad = {k: (m.get(k), v) for k, v in want.items() if m.get(k) != v}
        if bad:
            raise ValueError(
                f"exported artifact {path} does not match the model config: "
                + ", ".join(f"{k}: artifact={a!r} vs wanted={w!r}" for k, (a, w) in bad.items()))
    elif cfg is not None:
        LOGGER.warning("no manifest %s: cannot verify the artifact matches the model config",
                       manifest_path)
    if n_devices is not None and nr_devices is None:
        LOGGER.warning("no manifest %s: cannot verify the artifact's device count", manifest_path)
    elif n_devices is not None and nr_devices != n_devices:
        raise ValueError(
            f"exported artifact {path} was exported for {nr_devices} device(s) but the runner "
            f"serves {n_devices} - re-export with "
            + (f"--dp {n_devices}" if n_devices > 1 else "no --dp"))

    exported = torch.export.load(path)
    inputs = user_inputs(exported)
    traced_on = inputs[-1].device.type
    if platform is not None and traced_on != platform:
        raise ValueError(f"exported artifact {path} was traced on {traced_on} but the runner "
                         f"runs on {platform}: export with --device {platform}")
    if quantize is not None:
        # the frames are uint8, never int8: int8 inputs are quantized weights
        has_int8 = any(t.dtype == torch.int8 for t in inputs)
        if has_int8 != bool(quantize):
            raise ValueError(
                f"exported artifact {path} takes "
                f"{'an int8-quantized' if has_int8 else 'a full-precision'} param tree but the "
                f"runner is configured with quantize={bool(quantize)}: export with "
                f"{'--quantize' if quantize else 'no --quantize'} or drop the mismatched flag")
    if traced_on == "cuda":
        disable_tf32()
    return exported


def main(argv=None) -> None:
    import argparse

    from ..models.depth_pro import MODEL_PRESETS, apply_speed, model_preset, tiny_config

    ap = argparse.ArgumentParser(
        description="Export the depth inference program with torch.export (PyTorch/CUDA port)")
    ap.add_argument("-o", "--output", required=True, help="artifact path")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    ap.add_argument("--speed", default="exact",
                    help="speed preset baked into the exported program")
    ap.add_argument("--quantize", action="store_true",
                    help="export the int8-weight program (serve it with quantize=True)")
    ap.add_argument("--dp", type=int, default=0,
                    help="the data-parallel program of N ranks (each rank's program at "
                         "batch_size/N frames, served by a runner with a dp mesh of N "
                         "ranks); 0 = single-device")
    ap.add_argument("--tiny", action="store_true", help="miniature config (smoke tests)")
    ap.add_argument("--model", choices=list(MODEL_PRESETS), default="large",
                    help="model family member to export")
    ap.add_argument("--device", default="cuda",
                    help="device type the program is traced for: cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = tiny_config() if args.tiny else model_preset(args.model)
    if args.speed != "exact":
        cfg = apply_speed(cfg, args.speed)
    exported = export_infer(cfg, args.precision, args.batch_size, args.output,
                            quantize=args.quantize, device=args.device, dp=args.dp or 1)
    frames = user_inputs(exported)[-1]
    print(f"exported platform={frames.device.type} in={tuple(frames.shape)} "
          f"{frames.dtype} -> {args.output}")


if __name__ == "__main__":  # pragma: no cover
    main()
