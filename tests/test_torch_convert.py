"""The PyTorch port's checkpoint converter against the JAX package's.

The reference module tree (``tests/torch_oracle.py::TorchDepthPro``) at
``tiny_config()`` gives a state dict; the port's ``convert_depth_pro`` and
the JAX package's turn it into param trees that must agree leaf for leaf.
The port's forward on its tree is held against the oracle itself at the JAX
package's parity bar, rtol 1e-3 / atol 1e-4 (tests/test_depth_pro_parity.py:50),
fp32 on the CPU. A ``.pt`` goes through ``load_checkpoint``, and the JAX
package reads the port's npz.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu.ckpt import convert as jconvert
from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu_torch.ckpt import convert as tconvert
from ml_depth_pro_video_tpu_torch.ckpt.params import from_numpy_tree, load_params
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models.depth_pro import forward, load_checkpoint, tiny_config
from torch_oracle import TorchDepthPro

RTOL, ATOL = 1e-3, 1e-4
LEAF_TOL = 1e-7
CFG = tiny_config()
JCFG = j_tiny_config()


@pytest.fixture(scope="module")
def oracle():
    torch.manual_seed(0)
    return TorchDepthPro(JCFG).eval()


def _leaves(tree, path=""):
    """(path, leaf) pairs of a dict/list tree, ``None`` leaves included."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_same_tree(got, want, tol=LEAF_TOL):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if w is None:
            assert g is None, path
            continue
        g = g.detach().cpu().numpy() if hasattr(g, "detach") else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape, g.dtype)
        assert np.abs(g.astype(np.float64) - w).max(initial=0.0) <= tol, path


def test_convert_depth_pro_matches_jax_leaf_for_leaf(oracle):
    sd = oracle.state_dict()
    _assert_same_tree(tconvert.convert_depth_pro(sd, CFG), jconvert.convert_depth_pro(sd, JCFG))


def test_forward_on_converted_tree_matches_oracle(oracle):
    params = from_numpy_tree(tconvert.convert_depth_pro(oracle.state_dict(), CFG))
    x = np.random.default_rng(0).standard_normal((1, 3, CFG.img_size, CFG.img_size))
    x = x.astype(np.float32)
    with torch.no_grad():
        want_canon, want_fov = oracle(torch.from_numpy(x))
        canon, fov = forward(params, torch.from_numpy(x.transpose(0, 2, 3, 1)), CFG,
                             Precision.fp32())
    np.testing.assert_allclose(canon.numpy()[..., 0], want_canon.numpy()[:, 0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(fov.numpy(), want_fov.numpy().reshape(-1), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("suffix", [".pt", ".pth"])
def test_load_checkpoint_takes_a_reference_state_dict(oracle, tmp_path, suffix):
    path = tmp_path / f"depth_pro{suffix}"
    torch.save(oracle.state_dict(), path)
    got = load_checkpoint(dataclasses.replace(CFG, checkpoint_uri=str(path)))
    _assert_same_tree(got, jconvert.convert_depth_pro(oracle.state_dict(), JCFG))


def test_conversion_refuses_unconsumed_keys(oracle):
    sd = dict(oracle.state_dict())
    sd["encoder.stray.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="not consumed"):
        tconvert.convert_depth_pro(sd, CFG)
    sd.pop("encoder.stray.weight")
    sd["encoder.patch_encoder.fc_norm.weight"] = torch.zeros(2)  # exempt, as in the reference
    tconvert.convert_depth_pro(sd, CFG)


def test_saved_npz_reads_back_in_both_packages(oracle, tmp_path):
    tree = tconvert.convert_depth_pro(oracle.state_dict(), CFG)
    path = str(tmp_path / "tiny.npz")
    tconvert.save_params(path, from_numpy_tree(tree))  # torch leaves are written too
    _assert_same_tree(jconvert.load_params(path), tree, tol=0.0)
    _assert_same_tree(load_params(path), tree, tol=0.0)


def test_convert_checkpoint_cli_writes_the_tree(oracle, tmp_path, monkeypatch):
    pt, npz = tmp_path / "depth_pro.pt", tmp_path / "out.npz"
    torch.save(oracle.state_dict(), pt)
    monkeypatch.setattr("ml_depth_pro_video_tpu_torch.models.depth_pro.DEFAULT_MONODEPTH_CONFIG",
                        CFG)
    tconvert.main([str(pt), str(npz)])
    _assert_same_tree(load_params(str(npz)), jconvert.convert_depth_pro(oracle.state_dict(),
                                                                        JCFG))


@pytest.mark.parametrize("patch,new", [(14, 16), (16, 14)])
def test_resample_patch_embed_matches_jax(patch, new):
    w = np.random.default_rng(1).standard_normal((8, 3, patch, patch)).astype(np.float32)
    got, want = tconvert.resample_patch_embed(w, new), jconvert.resample_patch_embed(w, new)
    assert got.shape == (8, 3, new, new) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid,new", [(37, 24), (6, 8)])
def test_resample_pos_embed_matches_jax(grid, new):
    pos = np.random.default_rng(2).standard_normal((1, grid * grid + 1, 16)).astype(np.float32)
    got, want = tconvert.resample_pos_embed(pos, new), jconvert.resample_pos_embed(pos, new)
    assert got.shape == (1, new * new + 1, 16)
    np.testing.assert_array_equal(got, want)


def test_convert_vit_resamples_a_patch14_backbone():
    """A timm subtree at patch 14 / a 37x37 grid converts to the config's
    patch 16 / 8x8 grid exactly as the JAX package converts it."""
    vit = CFG.vit
    rng = np.random.default_rng(3)
    d, hidden = vit.embed_dim, vit.embed_dim * vit.mlp_ratio
    shapes = {"cls_token": (1, 1, d), "pos_embed": (1, 37 * 37 + 1, d),
              "patch_embed.proj.weight": (d, 3, 14, 14), "patch_embed.proj.bias": (d,),
              "norm.weight": (d,), "norm.bias": (d,)}
    for i in range(vit.depth):
        for key, shape in {"norm1.weight": (d,), "norm1.bias": (d,),
                           "attn.qkv.weight": (3 * d, d), "attn.qkv.bias": (3 * d,),
                           "attn.proj.weight": (d, d), "attn.proj.bias": (d,), "ls1.gamma": (d,),
                           "norm2.weight": (d,), "norm2.bias": (d,),
                           "mlp.fc1.weight": (hidden, d), "mlp.fc1.bias": (hidden,),
                           "mlp.fc2.weight": (d, hidden), "mlp.fc2.bias": (d,),
                           "ls2.gamma": (d,)}.items():
            shapes[f"blocks.{i}.{key}"] = shape
    sd = {f"v.{k}": torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    got = tconvert.convert_vit(sd, "v.", vit)
    assert got["patch_embed"]["w"].shape == (16 * 16 * 3, d)
    assert got["pos_embed"].shape == (1, vit.num_tokens, d)
    _assert_same_tree(got, jconvert.convert_vit(sd, "v.", JCFG.vit), tol=0.0)
