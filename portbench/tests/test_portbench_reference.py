"""The plain reference against the port's CPU path on the same seeded
weights, in fp32, at tiny presets (this test may import the port; the
reference may not)."""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.frames import make_frames
from portbench.reference import depth_pro as ref
from portbench.weights import make_weights

from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models.depth_pro import DepthProConfig, infer_fn
from ml_depth_pro_video_tpu_torch.models.vit import ViTConfig

TINY = ref.Arch(img_size=128, patch_size=16, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2,
                decoder_features=16, dims_encoder=(16, 32, 64, 64), hook_block_ids=(1, 2))


def port_config(arch: ref.Arch) -> DepthProConfig:
    vit = ViTConfig(img_size=arch.img_size, patch_size=arch.patch_size,
                    embed_dim=arch.embed_dim, depth=arch.depth, num_heads=arch.num_heads,
                    mlp_ratio=arch.mlp_ratio)
    return DepthProConfig(vit=vit, decoder_features=arch.decoder_features,
                          dims_encoder=arch.dims_encoder, hook_block_ids=arch.hook_block_ids,
                          token_merge_ratio=arch.token_merge_ratio,
                          token_merge_block=arch.token_merge_block, checkpoint_uri=None)


def port_infer(params, frames: np.ndarray, arch: ref.Arch) -> dict:
    x = torch.from_numpy(frames).float() / 127.5 - 1.0
    with torch.inference_mode():
        return infer_fn(params, x, None, port_config(arch), Precision.fp32())


@pytest.mark.parametrize("ratio", [0.0, 0.5], ids=["exact", "fast"])
def test_reference_equals_the_port_in_fp32(ratio):
    arch = dataclasses.replace(TINY, token_merge_ratio=ratio)
    params = make_weights(arch, 1234567, "cpu")
    frames = make_frames(2, 96, 160, 5, "cpu")
    got = port_infer(params, frames, arch)
    want = ref.infer(params, torch.from_numpy(frames), arch, torch.float32)
    inv, inv_ref = 1.0 / got["depth"], 1.0 / want["depth"]
    assert got["depth"].shape == want["depth"].shape == (2, 96, 160)
    assert torch.allclose(inv, inv_ref, rtol=1e-4, atol=1e-5 * inv_ref.abs().max())
    assert torch.allclose(got["focallength_px"], want["focallength_px"], rtol=1e-5)
    # the weights make every layer count: depth is not clamped and f_px is a camera's
    assert (want["depth"] < 1e4).all()
    assert 50 < float(want["focallength_px"].min()) < 1000


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (Path(ref.__file__), Path(ref.__file__).parents[1] / "weights.py",
                 Path(ref.__file__).parents[1] / "correct.py",
                 Path(ref.__file__).parents[1] / "flops.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not names & {"jax", "jaxlib", "flax", "ml_depth_pro_video_tpu",
                            "ml_depth_pro_video_tpu_torch"}, (path, names)
