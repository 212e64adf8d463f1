"""The port's ``torch.export`` artifact (``ckpt/export.py``) against the
port's eager program and the JAX package's exported program.

Counterpart of ``tests/test_export.py``: tiny config, fp32, on the CPU, the
params carried across from one npz (``tests/torch_checkpoint.py``). The
port's artifact runs the same aten ops and the same operators (their CPU
kernels: the plain versions) as eager ``infer_fn``, so the two agree bit
for bit; against JAX's StableHLO program the bar is the JAX tests' own,
rtol 1e-3 / atol 1e-4 (tests/test_depth_pro_parity.py:50).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_depth_pro_video_tpu.ckpt.export import export_infer as j_export_infer
from ml_depth_pro_video_tpu.ckpt.export import load_exported as j_load_exported
from ml_depth_pro_video_tpu.models.depth_pro import fold_head_params as j_fold_head_params
from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu_torch.ckpt import export as E
from ml_depth_pro_video_tpu_torch.ckpt.params import from_numpy_tree, load_params, map_tree
from ml_depth_pro_video_tpu_torch.ckpt.quantize import quantize_vit_weights
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models.depth_pro import DepthProModel, infer_fn, tiny_config
from torch_checkpoint import write_tiny_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CFG = tiny_config()
BATCH = 2
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny numpy param tree of the shared npz."""
    return load_params(write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "tiny.pt2")
    E.export_infer(CFG, "fp32", batch_size=BATCH, path=path, device="cpu")
    return path


def _runner_params(tree, quantize=False):
    """The tree as the runner holds it: int8 ViTs with ``quantize``, head folded."""
    params = from_numpy_tree(tree)
    if quantize:
        params = quantize_vit_weights(params)
    return DepthProModel(params, CFG).tree()


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (BATCH, CFG.img_size, CFG.img_size, 3), dtype=np.uint8)


def _eager(params, x):
    with torch.inference_mode():
        return infer_fn(params, x.float() / 127.5 - 1.0, None, CFG, Precision.fp32())


def _served(path, params, x, **kwargs):
    exported = E.load_exported(path, CFG, "fp32", device="cpu", **kwargs)
    with torch.inference_mode():
        return exported.module()(params, x)


def _targets(exported) -> list:
    return [str(n.target) for n in exported.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("depth_pro.")]


def test_roundtrip_equals_eager_infer_fn(artifact, tree):
    params = _runner_params(tree)
    x = torch.from_numpy(_frames())
    got, ref = _served(artifact, params, x, quantize=False, n_devices=1), _eager(params, x)
    assert set(got) == {"depth", "focallength_px"}
    for key in got:
        assert torch.equal(got[key], ref[key]), key


def test_artifact_matches_jax_exported_program(artifact, tree, tmp_path):
    """The same frames and params through JAX's ``export_infer`` +
    ``load_exported(...).call`` and through the port's artifact. Seen: max
    relative deviation 8.7e-6 of depth, 3.8e-7 of f_px (fp32 summed in two
    orders)."""
    jpath = str(tmp_path / "tiny.jaxexp")
    jcfg = j_tiny_config()
    j_export_infer(jcfg, "fp32", batch_size=BATCH, path=jpath)
    jparams = j_fold_head_params(jax.tree.map(jnp.asarray, tree))
    frames = _frames(1)
    want = j_load_exported(jpath, jcfg, "fp32").call(jparams, jnp.asarray(frames))
    got = _served(artifact, _runner_params(tree), torch.from_numpy(frames))
    for key in ("depth", "focallength_px"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL)


def test_graph_names_the_kernels_and_holds_no_weights(artifact):
    exported = torch.export.load(artifact)
    assert not exported.state_dict
    # one K1 per ViT block the tiny config runs: 2 blocks x (patch, image, FOV)
    assert _targets(exported) == ["depth_pro.attention_packed.default"] * (3 * CFG.vit.depth)
    # bf16 routes the decoder's small residual blocks to K2; a merge after
    # block 1 sends the patch ViT's later blocks to K3
    bf16 = _targets(E.export_infer(CFG, "bf16", batch_size=1, device="cpu"))
    assert "depth_pro.resblock.default" in bf16
    tome = _targets(E.export_infer(dataclasses.replace(CFG, token_merge_ratio=0.25,
                                                       token_merge_block=1), "fp32", 1,
                                   device="cpu"))
    assert tome.count("depth_pro.attention_packed_bias.default") == 1
    assert tome.count("depth_pro.attention_packed.default") == 3 * CFG.vit.depth - 1


def test_program_holds_every_input_to_its_traced_dtype(artifact, tree):
    """The module the runner serves is ``exported.module()`` as it loads: the
    graph's metadata asserts refuse frames or params of another dtype."""
    module = torch.export.load(artifact).module()
    params, x = _runner_params(tree), torch.from_numpy(_frames())
    with pytest.raises(RuntimeError, match="dtype mismatch! Expected: Byte"):
        module(params, x.float())
    half = {**params, "head": map_tree(torch.Tensor.half, params["head"])}
    with pytest.raises(RuntimeError, match="dtype mismatch! Expected: Float"):
        module(half, x)


def test_manifest_records_the_model(artifact):
    with open(artifact + ".json") as f:
        m = json.load(f)
    assert m == {"img_size": 512, "batch_size": BATCH, "vit_embed_dim": 64, "vit_depth": 2,
                 "compute_dtype": "float32", "token_merge_ratio": 0.0, "token_merge_block": 2,
                 "quantized": False, "platforms": ["cpu"], "nr_devices": 1}


@pytest.mark.parametrize("cfg,precision,kwargs,key", [
    (dataclasses.replace(CFG, vit=dataclasses.replace(CFG.vit, img_size=64)), "fp32", {},
     "img_size"),
    (dataclasses.replace(CFG, token_merge_ratio=0.5), "fp32", {}, "token_merge_ratio"),
    (CFG, "bf16", {}, "compute_dtype"),
    (CFG, "fp32", {"quantize": True}, "quantized"),
    (dataclasses.replace(CFG, vit=dataclasses.replace(CFG.vit, depth=3)), "fp32", {},
     "vit_depth"),
    (CFG, "fp32", {"device": "cuda"}, "platforms"),
])
def test_manifest_mismatch_raises(artifact, cfg, precision, kwargs, key):
    with pytest.raises(ValueError, match=key):
        E.load_exported(artifact, cfg, precision, **kwargs)


def test_artifact_traced_on_another_device_type_raises(artifact, tmp_path):
    """Without a manifest the artifact's own frames input names its device."""
    bare = str(tmp_path / "bare.pt2")
    Path(bare).write_bytes(Path(artifact).read_bytes())
    with pytest.raises(ValueError, match="traced on cpu"):
        E.load_exported(bare, device="cuda")


def test_quantized_roundtrip(tree, tmp_path):
    path = str(tmp_path / "tiny_int8.pt2")
    E.export_infer(CFG, "fp32", batch_size=BATCH, path=path, quantize=True, device="cpu")
    params = _runner_params(tree, quantize=True)
    x = torch.from_numpy(_frames(2))
    got, ref = _served(path, params, x, quantize=True), _eager(params, x)
    for key in got:
        assert torch.equal(got[key], ref[key]), key
    with pytest.raises(ValueError, match="quantized"):
        E.load_exported(path, CFG, "fp32", quantize=False)


def test_manifestless_artifact_refuses_the_wrong_weight_format(artifact, tmp_path):
    bare = str(tmp_path / "bare.pt2")
    Path(bare).write_bytes(Path(artifact).read_bytes())
    with pytest.raises(ValueError, match="full-precision param tree"):
        E.load_exported(bare, CFG, "fp32", quantize=True)
    assert E.load_exported(bare, CFG, "fp32", quantize=False) is not None


def test_multi_device_is_not_ported(artifact, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A item 10"):
        E.main(["-o", str(tmp_path / "dp.pt2"), "--tiny", "--device", "cpu", "--dp", "2"])
    with pytest.raises(ValueError, match="ROADMAP A item 10"):
        E.load_exported(artifact, CFG, "fp32", n_devices=2)


def test_main_writes_artifact_and_manifest(tmp_path, capsys):
    """``depth-pro-export-torch --tiny --device cpu``."""
    out = str(tmp_path / "cli.pt2")
    E.main(["-o", out, "--tiny", "--device", "cpu", "--batch_size", "2", "--precision", "fp32",
            "--speed", "balanced"])
    assert "exported platform=cpu in=(2, 512, 512, 3) torch.uint8" in capsys.readouterr().out
    with open(out + ".json") as f:
        m = json.load(f)
    assert (m["token_merge_ratio"], m["batch_size"], m["platforms"]) == (0.25, 2, ["cpu"])
    balanced = dataclasses.replace(CFG, token_merge_ratio=0.25)
    assert E.load_exported(out, balanced, "fp32", quantize=False, device="cpu") is not None


def test_loads_in_a_fresh_process(artifact):
    """``load_exported`` registers the operators before ``torch.export.load``,
    so the graph's ``depth_pro::*`` targets resolve in a new interpreter."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from ml_depth_pro_video_tpu_torch.ckpt.export import example_params, load_exported\n"
        "from ml_depth_pro_video_tpu_torch.ckpt.params import map_tree\n"
        "from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config\n"
        f"ep = load_exported({artifact!r}, tiny_config(), 'fp32', device='cpu')\n"
        "params = map_tree(torch.zeros_like, example_params(tiny_config(), device='cpu'))\n"
        f"x = torch.zeros(({BATCH}, 512, 512, 3), dtype=torch.uint8)\n"
        "with torch.inference_mode():\n"
        "    out = ep.module()(params, x)\n"
        "print(tuple(out['depth'].shape), bool(torch.isfinite(out['depth']).all()))\n"
    )
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT), env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"({BATCH}, 512, 512) True"
