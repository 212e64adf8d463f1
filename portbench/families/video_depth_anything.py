"""Video Depth Anything (Chen et al., arXiv:2501.12375): the family of
``video_depth_anything_large``.

- ``arch_of``: the shapes, ``portbench/reference/video_depth_anything.py``;
- ``make_weights``: the seeded state dict in upstream's module layout,
  ``portbench/weights_vda.py``;
- ``model_config``, ``build_runner``, ``launches``: the program adapter. The
  runner is the program's ``DepthVideoRunner`` on the program's
  ``VDAConfig``, given the benchmark's weights through its ``params=``
  argument after the program's own converter
  (``ckpt/convert_vda.py``), the route a real checkpoint takes.
  ``quantize=True`` is the control: the ViT's block matmul weights as
  per-channel int8 codes, the next precision below bf16. ``launches`` gives
  the K1 and K2 launch counters and the model's window counters;
- ``reference_answers``: the plain reference, once per sampled window, in
  frame blocks of 4.

The sample unit is one answer of a window: a sample key is ``(window,
position)``, and its input ``(the window's (T, H, W, 3) uint8 inputs, in
the order the window holds them, position)``; ``window_frames(w, arch)``
gives the stream indices of those inputs. An answer (``{"inverse_depth":
(H, W), ...}``, as the runner yields it) yields its inverse depth; there is
no f_px.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import video_depth_anything as ref
from portbench.weights_vda import make_weights

__all__ = ["YIELDS", "arch_of", "arrays", "build_runner", "launches", "make_weights",
           "model_config", "reference_answers", "sample", "window_frames"]

YIELDS = ("inverse_depth",)
arch_of = ref.arch_of
REFERENCE_BLOCK = 4  # frames a block through the reference's ViT and high-resolution head


def window_frames(w: int, arch) -> list[int]:
    """Stream indices of window ``w``'s inputs (upstream's ``KEYFRAMES`` rule)."""
    return ref.window_frames(w, arch.window, arch.keyframes)


def model_config(config: dict):
    """The program's ``VDAConfig`` for a configuration file."""
    from ml_depth_pro_video_tpu_torch.models.video_depth_anything import VDAConfig
    from ml_depth_pro_video_tpu_torch.models.vit import ViTConfig

    m = config["model"]
    if (m["num_transformer_block"], m["num_attention_blocks"], m["pos_embedding_type"]) != (
            1, 2, "ape") or m["overlap"] != len(m["keyframes"]):
        raise ValueError("the program runs one temporal block of two absolute-position "
                         "attentions, and a window's overlap is its keyframes")
    vit = ViTConfig(img_size=m["pretrain_size"], patch_size=m["patch_size"],
                    embed_dim=m["embed_dim"], depth=m["depth"], num_heads=m["num_heads"],
                    mlp_ratio=m["mlp_ratio"])
    return VDAConfig(vit=vit, hook_block_ids=tuple(m["intermediate_layer_idx"]),
                     features=m["features"], out_channels=tuple(m["out_channels"]),
                     head_features_2=m["head_features_2"],
                     temporal_heads=m["num_attention_heads"],
                     temporal_max_len=m["temporal_max_len"], norm_groups=m["norm_num_groups"],
                     window=m["infer_len"], keyframes=tuple(m["keyframes"]),
                     interp_len=m["interp_len"], input_size=m["input_size"],
                     checkpoint_uri=None).check()


def build_runner(config: dict, weights: dict, batch: int, device, quantize: bool = False,
                 stitch: bool = False):
    """A ``DepthVideoRunner`` on the benchmark's weights (``batch`` is the
    window's, set by the configuration)."""
    from ml_depth_pro_video_tpu_torch.ckpt.convert_vda import convert_video_depth_anything
    from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner

    cfg = model_config(config)
    params = convert_video_depth_anything(weights, cfg)
    return DepthVideoRunner(cfg=cfg, precision=config["model"]["precision"], device=device,
                            quantize=quantize, params=params, stitch=stitch)


def launches() -> dict:
    """The K1 and K2 launch counters and the model's window counters."""
    from ml_depth_pro_video_tpu_torch.models.video_depth_anything import COUNTERS
    from ml_depth_pro_video_tpu_torch.ops import attention, resblock

    return {"K1": attention.K1.launches, "K2": resblock.K2.launches, **COUNTERS}


def reference_answers(inputs: dict, weights_fn, arch, dtype, device,
                      block: int = REFERENCE_BLOCK) -> dict:
    """The reference's answer for each sample key ({(window, position):
    (frames, position)}), as (in the configuration's ``dtype``, in fp32):
    one reference pass a window and precision."""
    import torch

    sd = weights_fn()
    out = {}
    by_window: dict = {}
    for key, (frames, pos) in inputs.items():
        by_window.setdefault(key[0], (frames, []))[1].append((key, pos))
    for w in sorted(by_window):
        frames, keys = by_window[w]
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        res = [ref.infer_window(sd, x, arch, dt, block) for dt in (dtype, torch.float32)]
        for key, pos in keys:
            out[key] = tuple({"inverse_depth": r[pos].cpu().numpy()} for r in res)
        del x, res
    del sd
    return out


def sample(out: dict) -> dict:
    """What the sample keeps of one answer the runner yields, copied off its buffers."""
    return {"inverse_depth": np.array(out["inverse_depth"])}


def arrays(answer: dict) -> dict:
    """The arrays an answer or a reference answer yields for comparison."""
    return {"inverse_depth": np.asarray(answer["inverse_depth"], np.float64)}
