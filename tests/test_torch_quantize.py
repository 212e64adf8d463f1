"""The port's int8 weight-only ViT (``ckpt/quantize.py``) against the JAX package's.

Codes and scales must equal JAX's bit for bit (an all-zero output channel,
whose scale is 1, and values half way between two codes included), and so
must the bf16 dequantized weight. The port runs a tree that the JAX package
quantized, and both runners quantize their own params; both sides run fp32
on the CPU and the bar is the JAX package's parity bar, rtol 1e-3 / atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_depth_pro_video_tpu.ckpt import quantize as JQ
from ml_depth_pro_video_tpu.ckpt.convert import load_params as j_load_params
from ml_depth_pro_video_tpu.models import depth_pro as J
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.ckpt import params as P
from ml_depth_pro_video_tpu_torch.ckpt import quantize as TQ
from ml_depth_pro_video_tpu_torch.models import depth_pro as T
from ml_depth_pro_video_tpu_torch.models import vit as TV
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint

RTOL, ATOL = 1e-3, 1e-4
GAP = 1e-5  # a merge decided by a smaller similarity gap could flip between two packages
VITS = (("encoder", "patch_vit"), ("encoder", "image_vit"), ("fov", "vit"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


@pytest.fixture(scope="module")
def tree(checkpoint):
    """The tiny params with every leaf drawn from numpy (the checkpoint's)."""
    return j_load_params(checkpoint)


def _blocks(tree, vit):
    return tree[vit[0]][vit[1]]["blocks"]


def _crafted(tree):
    """``tree`` with an all-zero output channel and a channel whose codes fall
    half way between two integers (absmax 127: scale 1)."""
    tree = jax.tree.map(np.array, tree)
    blocks = _blocks(tree, VITS[0])
    blocks["qkv_w"][0, :, 5] = 0.0
    col = blocks["fc1_w"][1, :, 3]
    col[:] = 0.0
    col[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    return tree


def test_quantize_matches_jax_bit_for_bit(tree):
    tree = _crafted(tree)
    want = jax.tree.map(np.asarray, JQ.quantize_vit_weights(tree))
    got = TQ.quantize_vit_weights(P.from_numpy_tree(tree))
    for vit in VITS:
        for key in TQ._QUANT_KEYS:
            g, w = _blocks(got, vit)[key], _blocks(want, vit)[key]
            assert g["q"].dtype == torch.int8 and g["s"].dtype == torch.float32
            np.testing.assert_array_equal(g["q"].numpy(), w["q"])
            np.testing.assert_array_equal(g["s"].numpy(), w["s"])
        # the rest of the ViT is the same tensor, untouched
        assert _blocks(got, vit)["qkv_b"].dtype == torch.float32
    pv = _blocks(got, VITS[0])
    assert pv["qkv_w"]["s"][0, 0, 5].item() == 1.0 and not pv["qkv_w"]["q"][0, :, 5].any()
    assert pv["fc1_w"]["s"][1, 0, 3].item() == 1.0
    assert pv["fc1_w"]["q"][1, :6, 3].tolist() == [127, 0, 2, 2, 0, -2]  # half to even
    assert got["decoder"] is not None and "fov" in got


def test_from_numpy_tree_keeps_int8_codes_and_fp32_scales(tree):
    qtree = jax.tree.map(np.asarray, JQ.quantize_vit_weights(tree))
    t = P.from_numpy_tree(qtree)
    for vit in VITS:
        for key in TQ._QUANT_KEYS:
            leaf = _blocks(t, vit)[key]
            assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
            np.testing.assert_array_equal(leaf["q"].numpy(), _blocks(qtree, vit)[key]["q"])
    # held as frozen module parameters; tree() gives the {'q', 's'} dicts back
    model = T.DepthProModel(t, T.tiny_config())
    int8 = {n for n, p in model.named_parameters() if p.dtype == torch.int8}
    assert len(int8) == 3 * 4 and all(not p.requires_grad for p in model.parameters())
    back = model.tree()["fov"]["vit"]["blocks"]["fc2_w"]
    assert set(back) == {"q", "s"} and back["q"].dtype == torch.int8


def _merge_is_decisive(tokens: torch.Tensor, ratio: float) -> None:
    """The gaps that change a merge's output (the merge boundary, the merged
    tokens' best matches) exceed GAP."""
    x = tokens.double()[:, 1:]
    a, b = x[:, 0::2], x[:, 1::2]
    r = min(int(ratio * x.shape[1]), a.shape[1])
    sim = torch.nn.functional.normalize(a, dim=-1) @ torch.nn.functional.normalize(b, dim=-1).mT
    top2 = sim.topk(2, dim=-1).values
    best, match_gap = top2[..., 0], top2[..., 0] - top2[..., 1]
    order = torch.sort(best, dim=-1, descending=True)
    assert (order.values[:, r - 1] - order.values[:, r]).min() > GAP, "near-tie at the boundary"
    assert torch.gather(match_gap, 1, order.indices[:, :r]).min() > GAP, "near-tie in a match"


@pytest.mark.parametrize("ratio", [0.0, 0.25])
def test_port_forward_on_the_jax_quantized_tree(tree, ratio, monkeypatch):
    """The port's infer_fn on JAX's quantized tree against JAX's infer_fn on
    it, exact and with a token merge after block 1 of the 2-block ViT."""
    qtree = jax.tree.map(np.asarray, JQ.quantize_vit_weights(tree))
    jcfg = dataclasses.replace(J.tiny_config(), token_merge_ratio=ratio, token_merge_block=1)
    tcfg = dataclasses.replace(T.tiny_config(), token_merge_ratio=ratio, token_merge_block=1)
    merges = []
    real = TV.compute_token_merge

    def recording(tokens, r):
        merges.append(tokens)
        return real(tokens, r)

    monkeypatch.setattr(TV, "compute_token_merge", recording)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 80, 100, 3)).astype(np.float32)
    with torch.inference_mode():
        got = T.infer_fn(P.from_numpy_tree(qtree), torch.from_numpy(x), None, tcfg)
    want = J.infer_fn(jax.tree.map(jnp.asarray, qtree), jnp.asarray(x), None, jcfg)
    assert len(merges) == (1 if ratio else 0)
    for tokens in merges:
        _merge_is_decisive(tokens, ratio)
    for k in ("depth", "focallength_px"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL)


def test_quantized_runner_matches_jax_runner(checkpoint):
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (60, 84, 3), dtype=np.uint8) for _ in range(3)]
    port = DepthVideoRunner(cfg=dataclasses.replace(T.tiny_config(), checkpoint_uri=checkpoint),
                            precision="fp32", batch_size=2, decode_workers=1, quantize=True,
                            device="cpu")
    jaxr = JaxRunner(cfg=dataclasses.replace(J.tiny_config(), checkpoint_uri=checkpoint),
                     precision="fp32", batch_size=2, decode_workers=1, quantize=True)
    assert port.params["encoder"]["image_vit"]["blocks"]["proj_w"]["q"].dtype == torch.int8
    got, ref = list(port.depth_stream(frames)), list(jaxr.depth_stream(frames))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["depth"], r["depth"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["focallength_px"], r["focallength_px"], rtol=RTOL,
                                   atol=ATOL)


def test_materialize_weight_in_bf16_matches_jax(tree):
    tree = _crafted(tree)
    qj = JQ.quantize_vit_weights(tree)
    qt = TQ.quantize_vit_weights(P.from_numpy_tree(tree))
    for key in TQ._QUANT_KEYS:
        wj, wt = _blocks(qj, VITS[0])[key], _blocks(qt, VITS[0])[key]
        for layer in range(wt["q"].shape[0]):
            got = TQ.materialize_weight({k: v[layer] for k, v in wt.items()}, torch.bfloat16)
            want = JQ.materialize_weight({k: v[layer] for k, v in wj.items()}, jnp.bfloat16)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(want).view(np.int16))
    plain = torch.randn(4, 5)
    assert torch.equal(TQ.materialize_weight(plain, torch.bfloat16), plain.bfloat16())
