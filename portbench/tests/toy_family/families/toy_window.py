"""The toy window family: an answer depends on a window of frames, and it
yields inverse depth alone (no f_px).

A sample key is ``(start, position)``: the stream index of its window's
first frame and the answer's position in the window; its input is
``(the window's (T, H, W, 3) uint8 frames, position)``. The reference runs
once a window.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench import run

HERE = Path(__file__).resolve().parents[1]
ref = run.load_module(HERE / "reference" / "toy_window.py", "portbench_reference_toy_window")
stub = run.load_module(HERE / "stubs" / "toy_window.py", "portbench_stub_toy_window")

YIELDS = ("inverse_depth",)
arch_of = ref.arch_of


def make_weights(arch, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    c, pix = arch.channels, arch.patch ** 2 * 3
    shapes = {"embed": (pix, c), "qkv": (c, 3 * c), "out": (c, c), "head": (c, 1)}
    return {k: torch.randn(s, generator=gen, device=device) * s[0] ** -0.5
            for k, s in shapes.items()}


def model_config(config: dict):
    return arch_of(config)


def build_runner(config: dict, weights: dict, batch: int, device, quantize: bool = False):
    if quantize:
        raise ValueError("the toy window family has no control")
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[config["model"]["precision"]]
    return stub.ToyWindowRunner(weights, model_config(config), dtype)


def launches() -> dict:
    return {"windows": stub.ToyWindowRunner.windows}


def reference_answers(inputs: dict, weights_fn, arch, dtype, device) -> dict:
    params = weights_fn()
    out, done = {}, {}
    for key, (frames, pos) in sorted(inputs.items()):
        start = key[0]
        if start not in done:
            x = torch.from_numpy(frames).to(device)
            done[start] = [ref.infer(params, x, arch, dt) for dt in (dtype, torch.float32)]
        out[key] = tuple({"inverse_depth": r[pos].cpu().numpy()} for r in done[start])
    return out


def sample(out: dict) -> dict:
    return {"inverse_depth": np.array(out["inverse_depth"])}


def arrays(answer: dict) -> dict:
    return {"inverse_depth": np.asarray(answer["inverse_depth"], np.float64)}
