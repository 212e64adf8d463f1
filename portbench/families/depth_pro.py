"""Depth Pro (Apple, arXiv:2410.02073): the family of ``depth_pro_large`` and
``depth_pro_large_fast``, and of every configuration file without a
``"family"`` key.

Its pieces stay where the benchmark's first cells put them; this module
hands them to the harness:

- ``arch_of``: the shapes, ``portbench/reference/depth_pro.py``;
- ``make_weights``: the seeded tree, ``portbench/weights.py``;
- ``model_config``, ``build_runner``, ``launches``: the program adapter,
  ``portbench/program.py`` (``DepthVideoRunner`` on the benchmark's weights;
  ``quantize=True`` is the control, the ViTs' int8 path, the next precision
  below bf16; the K1, K3 and K2 launch counters);
- ``reference_answers``: the plain reference, two frames at a time.

The sample unit is one frame: a sample key is the frame's id in the traffic
kind's pool, and its input the (H, W, 3) uint8 frame. An answer (``{"depth":
(H, W), "focallength_px"}``, as the runner yields them) yields its inverse
depth and its f_px for comparison.
"""

from __future__ import annotations

import numpy as np

from portbench.program import build_runner, launches, model_config
from portbench.reference.depth_pro import arch_of
from portbench.weights import make_weights

__all__ = ["YIELDS", "arch_of", "arrays", "build_runner", "launches", "make_weights",
           "model_config", "reference_answers", "sample"]

YIELDS = ("inverse_depth", "focallength_px")


def reference_answers(inputs: dict, weights_fn, arch, dtype, device, block: int = 2) -> dict:
    """The reference's answer for each distinct frame ({frame id: uint8
    (H, W, 3)}), as (in the configuration's ``dtype``, in fp32), computed
    ``block`` frames at a time."""
    import torch

    from portbench.reference import depth_pro as ref

    params = weights_fn()
    out = {}
    ids = sorted(inputs)
    for i in range(0, len(ids), block):
        chunk = ids[i:i + block]
        x = torch.from_numpy(np.stack([inputs[j] for j in chunk])).to(device)
        res = [ref.infer(params, x, arch, dt) for dt in (dtype, torch.float32)]
        for n, j in enumerate(chunk):
            out[j] = tuple({"depth": r["depth"][n].float().cpu().numpy(),
                            "focallength_px": float(r["focallength_px"][n])} for r in res)
    del params
    return out


def sample(out: dict) -> dict:
    """What the sample keeps of one answer the runner yields, copied off its buffers."""
    return {"depth": np.array(out["depth"]), "focallength_px": out["focallength_px"]}


def arrays(answer: dict) -> dict:
    """The arrays an answer or a reference answer yields for comparison."""
    return {"inverse_depth": 1.0 / np.asarray(answer["depth"], np.float64),
            "focallength_px": float(answer["focallength_px"])}
