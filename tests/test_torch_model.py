"""The PyTorch port's ViT, Depth Pro model and param bridge against the JAX package.

Params come from the JAX package's ``init_depth_pro`` and then EVERY leaf
is redrawn from a numpy seed (biases, LayerNorm gains and LayerScale
included: the JAX init sets LayerScale to 1e-5 and biases to 0, which
would make every ViT block nearly the identity and hide an attention or
MLP bug). The same numpy tree goes to both packages. Both run fp32 on the
CPU; the bar is the JAX package's own parity bar, rtol 1e-3 / atol 1e-4
(tests/test_depth_pro_parity.py:50), and the port lands far inside it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_depth_pro_video_tpu.ckpt.convert import save_params
from ml_depth_pro_video_tpu.ckpt.quantize import quantize_vit_weights
from ml_depth_pro_video_tpu.models import depth_pro as J
from ml_depth_pro_video_tpu.models import vit as JV
from ml_depth_pro_video_tpu_torch.ckpt import params as P
from ml_depth_pro_video_tpu_torch.models import depth_pro as T
from ml_depth_pro_video_tpu_torch.models import vit as TV

RTOL, ATOL = 1e-3, 1e-4
CFG = J.tiny_config()
TCFG = T.tiny_config()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def randomized(tree, seed: int = 0) -> dict:
    """``tree`` with every leaf redrawn from numpy: mean + N(0, 1) * (the
    leaf's std, or 0.1 for constant leaves such as biases and LayerScale)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a, np.float32)
        std = float(a.std())
        return (a.mean() + rng.standard_normal(a.shape) * (std if std > 0 else 0.1)
                ).astype(np.float32)

    return jax.tree.map(redraw, tree)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's own init (jitted: one compile instead of many eager ops)."""
    tree = jax.jit(J.init_depth_pro, static_argnums=1)(jax.random.PRNGKey(3), CFG)
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params(jax_init):
    return randomized(jax_init)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=rtol, atol=atol)


def test_configs_match_jax():
    for name in ("large", "base", "small", "tiny"):
        assert dataclasses.asdict(T.model_preset(name)) == dataclasses.asdict(J.model_preset(name))
    large = T.model_preset("large")
    assert (large.vit.embed_dim, large.vit.depth, large.vit.num_heads, large.img_size,
            large.decoder_features) == (1024, 24, 16, 1536, 256)
    assert TV.VIT_CONFIG_DICT.keys() == JV.VIT_CONFIG_DICT.keys()


def test_vit_apply_with_captures_matches_jax(params):
    vit_p = params["encoder"]["patch_vit"]
    x = np.random.default_rng(1).standard_normal((3, 128, 128, 3)).astype(np.float32)
    j_tokens, j_caps = jax.jit(lambda p, xx: JV.vit_apply(p, xx, CFG.vit, capture_blocks=(1, 0)))(
        _jtree(vit_p), jnp.asarray(x))
    vit = TV.ViT(P.from_numpy_tree(vit_p), TCFG.vit)
    t_tokens, t_caps = vit(torch.from_numpy(x), capture_blocks=(1, 0))
    _close(t_tokens, j_tokens)
    assert len(t_caps) == len(j_caps) == 2
    for t, j in zip(t_caps, j_caps):
        _close(t, j)


def test_forward_matches_jax(params):
    x = np.random.default_rng(2).standard_normal((1, 512, 512, 3)).astype(np.float32)
    j_canon, j_fov = jax.jit(lambda p, xx: J.forward(p, xx, CFG))(_jtree(params), jnp.asarray(x))
    with torch.inference_mode():
        t_canon, t_fov = T.DepthProModel(P.from_numpy_tree(params), TCFG)(torch.from_numpy(x))
    _close(t_canon, j_canon)
    _close(t_fov, j_fov)


@pytest.mark.parametrize("case", ["fpx_absent", "fpx_given", "mixed_nan"])
def test_infer_fn_non_square_matches_jax(params, case):
    x = np.random.default_rng(3).standard_normal((2, 140, 250, 3)).astype(np.float32)
    f = {"fpx_absent": None, "fpx_given": np.array([300.0, 420.0], np.float32),
         "mixed_nan": np.array([np.nan, 420.0], np.float32)}[case]
    mixed = case == "mixed_nan"
    j = jax.jit(lambda p, xx, ff: J.infer_fn(p, xx, ff, CFG, derive_missing=mixed))(
        _jtree(params), jnp.asarray(x), None if f is None else jnp.asarray(f))
    with torch.inference_mode():
        t = T.infer_fn(P.from_numpy_tree(params), torch.from_numpy(x),
                       None if f is None else torch.from_numpy(f), TCFG, derive_missing=mixed)
    assert t["depth"].shape == (2, 140, 250)
    _close(t["depth"], j["depth"])
    _close(t["focallength_px"], j["focallength_px"])
    if mixed:
        assert t["focallength_px"][1].item() == 420.0


def test_infer_requires_fpx_without_fov_head():
    cfg = T.tiny_config(use_fov_head=False)
    tree = P.init_depth_pro(cfg, torch.Generator().manual_seed(0))
    assert "fov" not in tree
    with pytest.raises(ValueError, match="f_px is required"):
        T.infer_fn(tree, torch.zeros(1, 64, 64, 3), None, cfg)


def test_from_numpy_tree_keeps_jax_tree_exactly(jax_init):
    ported = P.from_numpy_tree(jax_init)
    j_leaves, j_def = jax.tree.flatten(jax_init)
    t_leaves, t_def = jax.tree.flatten(P.to_numpy_tree(ported))
    assert j_def == t_def
    for a, b in zip(j_leaves, t_leaves):
        np.testing.assert_array_equal(a, b)


def test_port_init_builds_the_jax_tree_structure():
    for fov in (True, False):
        cfg, tcfg = J.tiny_config(fov), T.tiny_config(fov)
        j_shapes = jax.eval_shape(lambda: J.init_depth_pro(jax.random.PRNGKey(0), cfg))
        t_tree = P.init_depth_pro(tcfg, torch.Generator().manual_seed(0))
        t_shapes = P.map_tree(lambda t: tuple(t.shape), t_tree)
        assert jax.tree.structure(j_shapes) == jax.tree.structure(
            t_shapes, is_leaf=lambda v: isinstance(v, tuple))
        assert [a.shape for a in jax.tree.leaves(j_shapes)] == jax.tree.leaves(
            t_shapes, is_leaf=lambda v: isinstance(v, tuple))


def test_port_init_is_seeded_and_scaled():
    a = P.init_depth_pro(TCFG, torch.Generator().manual_seed(5))
    b = P.init_depth_pro(TCFG, torch.Generator().manual_seed(5))
    qkv = a["encoder"]["patch_vit"]["blocks"]["qkv_w"]
    torch.testing.assert_close(qkv, b["encoder"]["patch_vit"]["blocks"]["qkv_w"], rtol=0, atol=0)
    assert abs(qkv.std().item() - TCFG.vit.embed_dim ** -0.5) < 0.02
    assert torch.all(a["encoder"]["patch_vit"]["blocks"]["ls1"] == 1e-5)


def test_save_params_roundtrip_through_port_loader(params, tmp_path):
    path = str(tmp_path / "params.npz")
    save_params(path, params)
    loaded = P.load_params(path)
    assert loaded["decoder"]["convs"][0] is None
    assert loaded["decoder"]["fusions"][0]["deconv_w"] is None
    j_leaves, j_def = jax.tree.flatten(params)
    l_leaves, l_def = jax.tree.flatten(loaded)
    assert j_def == l_def
    for a, b in zip(j_leaves, l_leaves):
        np.testing.assert_array_equal(a, b)


def test_quantized_tree_is_refused(params):
    with pytest.raises(NotImplementedError, match="int8"):
        P.from_numpy_tree(jax.tree.map(np.asarray, quantize_vit_weights(_jtree(params))))


def test_model_tree_roundtrip_and_state_dict(params):
    model = T.DepthProModel(P.from_numpy_tree(params), TCFG)
    tree = model.tree()
    assert "folded_wcomp" in tree["head"]
    flat = jax.tree.map(lambda t: t.numpy(), {k: v for k, v in tree.items()})
    flat["head"].pop("folded_wcomp")
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(flat)):
        np.testing.assert_array_equal(a, b)
    assert all(not p.requires_grad for p in model.parameters())
    n = sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(params))
    folded = int(np.prod(tree["head"]["folded_wcomp"].shape))
    assert sum(p.numel() for p in model.parameters()) == n + folded


def test_depth_pro_api_on_cpu(params):
    model, transform = T.create_model_and_transforms(TCFG, device="cpu")
    img = np.random.default_rng(4).integers(0, 256, (70, 90, 3), dtype=np.uint8)
    x = transform(img)
    assert x.shape == (70, 90, 3) and float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    out = model.infer(x)
    assert out["depth"].shape == (70, 90) and out["focallength_px"].dim() == 0
    chw = model.infer(x.permute(2, 0, 1)[None], f_px=500.0)
    assert chw["depth"].shape == (1, 70, 90)
    assert float(chw["focallength_px"][0]) == 500.0
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            T.create_model_and_transforms(TCFG, device="cuda")
        else:
            raise RuntimeError("CUDA present")
