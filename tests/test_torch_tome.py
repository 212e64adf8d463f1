"""The PyTorch port's ToMe speed tiers against the JAX package's.

Token merging (``compute_token_merge``, ``unmerge_tokens``), the merge
schedule of ``vit_apply``, ``infer_fn`` at ``apply_speed(..., "balanced" |
"fast")`` and the checked-in quality-gate proxy
(``tests/fixtures/tome_proxy_weights.npz``) run through both packages on the
same numpy inputs and weights, fp32 on the CPU. The bar is rtol 1e-3 /
atol 1e-4; gather maps must be identical.

A merge depends on an argmax per A token and on the order of the best
similarities, so a near-tie could flip between two correct
implementations. Every test therefore asserts that the gaps that decide
its merges exceed 1e-5 (fp32 rounding of these similarities is ~1e-7):
where the gather map is compared, the gap between each row's two best
similarities and between all neighbouring sorted best similarities; where
only the output is compared, the gaps that change the output: the one at
the merge boundary (rank r against r+1) and the best-match gaps of the
merged tokens.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_depth_pro_video_tpu.ckpt.convert import load_params as j_load_params
from ml_depth_pro_video_tpu.models import depth_pro as J
from ml_depth_pro_video_tpu.models import vit as JV
from ml_depth_pro_video_tpu.utils.synthetic import tome_proxy_config as j_tome_proxy_config
from ml_depth_pro_video_tpu_torch.ckpt import params as P
from ml_depth_pro_video_tpu_torch.models import depth_pro as T
from ml_depth_pro_video_tpu_torch.models import vit as TV

RTOL, ATOL = 1e-3, 1e-4
GAP = 1e-5
PROXY = str(Path(__file__).resolve().parent / "fixtures" / "tome_proxy_weights.npz")
# the port's twin of the proxy's config lives beside its one other user, chip_smoke.py
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=rtol, atol=atol)


def assert_no_near_tie(tokens, ratio, check_order=True, whole_map=True):
    """Fail unless the merge of ``tokens`` (B, S, D) at ``ratio`` is decided
    by gaps above GAP. ``whole_map``: every A token's best match and (with
    ``check_order``) the whole order of the best similarities, which fix the
    gather map. Otherwise only what changes the output: the gap at the merge
    boundary and the best matches of the merged tokens."""
    x = np.asarray(tokens, np.float64)[:, 1:]
    a, b = x[:, 0::2], x[:, 1::2]
    na, r = a.shape[1], min(int(ratio * x.shape[1]), a.shape[1])
    an = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-6)
    bn = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-6)
    sim = np.sort(np.einsum("bad,bcd->bac", an, bn), axis=-1)
    best, match_gap = sim[..., -1], sim[..., -1] - sim[..., -2]
    if whole_map:
        assert match_gap.min() > GAP, "near-tie in a best match"
        if check_order:
            assert np.diff(np.sort(best, axis=-1), axis=-1).min() > GAP, \
                "near-tie in the merge order"
        return
    order = np.argsort(-best, axis=-1, kind="stable")
    ranked = np.take_along_axis(best, order, axis=-1)
    if r < na:
        assert (ranked[:, r - 1] - ranked[:, r]).min() > GAP, "near-tie at the merge boundary"
    merged_gap = np.take_along_axis(match_gap, order[:, :r], axis=-1)
    assert merged_gap.min() > GAP, "near-tie in a merged token's best match"


@pytest.fixture
def merge_inputs(monkeypatch):
    """Records the tokens every port merge sees, so a test can check them
    for near-ties (a tie there would make both packages right and unequal)."""
    seen = []
    real = TV.compute_token_merge

    def recording(tokens, ratio):
        seen.append((tokens.detach().float().numpy().copy(), ratio))
        return real(tokens, ratio)

    monkeypatch.setattr(TV, "compute_token_merge", recording)
    return seen


def _check_recorded(seen, expect):
    """The port merged ``expect`` times, each time decided by clear gaps in
    what changes the output (the tests that use this compare outputs)."""
    assert len(seen) == expect
    for tokens, ratio in seen:
        assert_no_near_tie(tokens, ratio, whole_map=False)


def randomized(tree, seed: int = 0):
    """``tree`` with every leaf redrawn from numpy (biases and LayerScale too,
    so that no block is nearly the identity)."""
    rng = np.random.default_rng(seed)

    def redraw(a):
        a = np.asarray(a, np.float32)
        std = float(a.std())
        return (a.mean() + rng.standard_normal(a.shape) * (std if std > 0 else 0.1)
                ).astype(np.float32)

    return jax.tree.map(redraw, tree)


# ---------------------------------------------------------------------------
# compute_token_merge / unmerge_tokens


def _merge_both(x, ratio):
    t = TV.compute_token_merge(torch.from_numpy(x), ratio)
    j = JV.compute_token_merge(jnp.asarray(x), ratio)
    return t, j


def _assert_merge_equal(t, j):
    (tm, tg, tl), (jm, jg, jl) = t, j
    assert tg.dtype == torch.int64 and tl.dtype == torch.float32
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    _close(tm, jm)
    _close(tl, jl)
    _close(TV.unmerge_tokens(tm, tg), JV.unmerge_tokens(jm, jg))


def test_token_merge_roundtrip_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 17, 8)).astype(np.float32)
    assert_no_near_tie(x, 0.25)
    t, j = _merge_both(x, 0.25)  # 16 patch tokens: r = 4
    _assert_merge_equal(t, j)
    merged, gmap, log_sizes = t
    assert merged.shape == (3, 13, 8) and gmap.shape == (3, 17)
    full = TV.unmerge_tokens(merged, gmap).numpy()
    np.testing.assert_array_equal(full[:, 0], x[:, 0])  # cls is never merged
    diff = np.abs(full - x).max(axis=-1)
    assert (diff > 1e-6).sum(axis=1).max() <= 2 * 4
    # sizes: kept tokens stand for 1, and all sizes add up to the sequence
    sizes = np.exp(log_sizes.numpy())
    np.testing.assert_allclose(sizes[:, :1 + 8 - 4], 1.0, atol=1e-6)
    np.testing.assert_allclose(sizes.sum(axis=1), 17, rtol=1e-6)


def test_token_merge_duplicates_are_lossless_like_jax():
    x = np.random.default_rng(1).standard_normal((1, 9, 4)).astype(np.float32)
    for a, b in ((1, 2), (3, 4), (5, 6), (7, 8)):
        x[:, a] = x[:, b]
    # every A token matches its twin exactly (sim 1): the order of the four
    # ties does not matter, since r = 4 merges all of A
    assert_no_near_tie(x, 0.5, check_order=False)
    t, j = _merge_both(x, 0.5)
    _assert_merge_equal(t, j)
    np.testing.assert_allclose(TV.unmerge_tokens(t[0], t[1]).numpy(), x, rtol=1e-6, atol=1e-6)


def test_token_merge_full_a_set_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 17, 8)).astype(np.float32)
    assert_no_near_tie(x, 0.99)
    t, j = _merge_both(x, 0.99)  # r = min(15, na = 8) = 8
    _assert_merge_equal(t, j)
    assert t[0].shape == (2, 9, 8)


def test_token_merge_noop_ratio_is_none_like_jax():
    x = np.random.default_rng(3).standard_normal((2, 17, 8)).astype(np.float32)
    t, j = _merge_both(x, 0.05)  # r = int(0.05 * 16) = 0
    assert t is None and j is None


def test_token_merge_of_bf16_tokens_uses_fp32_similarity():
    x = np.random.default_rng(4).standard_normal((2, 33, 16)).astype(np.float32)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact values
    assert_no_near_tie(xb, 0.25)
    t = TV.compute_token_merge(torch.from_numpy(xb).bfloat16(), 0.25)
    j = JV.compute_token_merge(jnp.asarray(xb, jnp.bfloat16), 0.25)
    assert t[0].dtype == torch.bfloat16 and t[2].dtype == torch.float32
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    _close(t[0], j[0].astype(jnp.float32), rtol=0, atol=0)
    _close(t[2], j[2])


# ---------------------------------------------------------------------------
# vit_apply with the merge


VCFG = TV.ViTConfig(img_size=64, patch_size=16, embed_dim=32, depth=4, num_heads=4,
                    mlp_ratio=2)


@pytest.fixture(scope="module")
def vit_params():
    jcfg = JV.ViTConfig(**dataclasses.asdict(VCFG))
    return randomized(jax.tree.map(np.asarray, JV.init_vit(jax.random.PRNGKey(0), jcfg)), 7)


def _vit_both(params, x, **kw):
    jcfg = JV.ViTConfig(**dataclasses.asdict(VCFG))
    j = JV.vit_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg, **kw)
    t = TV.vit_apply(P.from_numpy_tree(params), torch.from_numpy(x), VCFG, **kw)
    return t, j


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_vit_apply_merge_with_captures_matches_jax(vit_params, merge_inputs, ratio):
    """Captures before (block 1) and after (block 2) the merge point, and the
    final tokens, all unmerged to full length."""
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    (t_tok, t_caps), (j_tok, j_caps) = _vit_both(vit_params, x, capture_blocks=(2, 1),
                                                 merge_ratio=ratio, merge_block=2)
    _check_recorded(merge_inputs, 1)
    assert t_tok.shape == (2, 17, 32) and [c.shape for c in t_caps] == [(2, 17, 32)] * 2
    _close(t_tok, j_tok)
    for t, j in zip(t_caps, j_caps):
        _close(t, j)
    exact, caps = TV.vit_apply(P.from_numpy_tree(vit_params), torch.from_numpy(x), VCFG,
                               capture_blocks=(1, 2))
    torch.testing.assert_close(t_caps[0], caps[0], rtol=0, atol=0)  # before the merge: exact
    assert (t_tok - exact).abs().max() > 0  # after it: an approximation


def test_vit_apply_noop_ratio_is_exact(vit_params):
    x = np.random.default_rng(6).standard_normal((2, 64, 64, 3)).astype(np.float32)
    p = P.from_numpy_tree(vit_params)
    exact, caps_e = TV.vit_apply(p, torch.from_numpy(x), VCFG, capture_blocks=(1, 3))
    (noop, caps_n), (j_noop, _) = _vit_both(vit_params, x, capture_blocks=(1, 3),
                                            merge_ratio=0.05, merge_block=1)
    torch.testing.assert_close(noop, exact, rtol=0, atol=0)
    for a, b in zip(caps_n, caps_e):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _close(noop, j_noop)


def test_vit_apply_merge_after_last_block_is_skipped(vit_params, merge_inputs):
    x = np.random.default_rng(7).standard_normal((1, 64, 64, 3)).astype(np.float32)
    p = P.from_numpy_tree(vit_params)
    exact, _ = TV.vit_apply(p, torch.from_numpy(x), VCFG)
    out, _ = TV.vit_apply(p, torch.from_numpy(x), VCFG, merge_ratio=0.5, merge_block=4)
    torch.testing.assert_close(out, exact, rtol=0, atol=0)
    assert merge_inputs == []
    (late, _), (j_late, _) = _vit_both(vit_params, x, merge_ratio=0.5, merge_block=3)
    _check_recorded(merge_inputs, 1)
    _close(late, j_late)
    assert (late - exact).abs().max() > 0


# ---------------------------------------------------------------------------
# the speed tiers end to end


def test_speed_presets_match_jax():
    assert T.SPEED_PRESETS == J.SPEED_PRESETS
    for speed in T.SPEED_PRESETS:
        assert dataclasses.asdict(T.apply_speed(T.tiny_config(), speed)) == dataclasses.asdict(
            J.apply_speed(J.tiny_config(), speed))
    with pytest.raises(ValueError, match="speed must be one of"):
        T.apply_speed(T.tiny_config(), "fastest")
    assert dataclasses.asdict(chip_smoke.tome_proxy_config()) == dataclasses.asdict(j_tome_proxy_config())


@pytest.fixture(scope="module")
def tiny_params():
    tree = jax.jit(J.init_depth_pro, static_argnums=1)(jax.random.PRNGKey(5), J.tiny_config())
    return randomized(jax.tree.map(np.asarray, tree), 3)


def _infer_both(params, x, f, tcfg, jcfg):
    j = J.infer_fn(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                   None if f is None else jnp.asarray(f), jcfg)
    with torch.inference_mode():
        t = T.infer_fn(P.from_numpy_tree(params), torch.from_numpy(x),
                       None if f is None else torch.from_numpy(f), tcfg)
    return t, j


@pytest.mark.parametrize("speed", ["balanced", "fast"])
def test_infer_fn_speed_tier_matches_jax(tiny_params, merge_inputs, speed):
    """At the presets the tiny config (2 blocks, merge after block 2) skips
    the merge and equals the exact path; with the merge after block 1 it
    merges in the patch ViT only."""
    x = np.random.default_rng(8).standard_normal((1, 200, 260, 3)).astype(np.float32)
    t, j = _infer_both(tiny_params, x, None, T.apply_speed(T.tiny_config(), speed),
                       J.apply_speed(J.tiny_config(), speed))
    exact, _ = _infer_both(tiny_params, x, None, T.tiny_config(), J.tiny_config())
    torch.testing.assert_close(t["depth"], exact["depth"], rtol=0, atol=0)
    assert merge_inputs == []
    tcfg = dataclasses.replace(T.apply_speed(T.tiny_config(), speed), token_merge_block=1)
    jcfg = dataclasses.replace(J.apply_speed(J.tiny_config(), speed), token_merge_block=1)
    t, j = _infer_both(tiny_params, x, None, tcfg, jcfg)
    _check_recorded(merge_inputs, 1)
    assert merge_inputs[0][0].shape[0] == 35  # the 35-patch ViT, not the image or FOV ViT
    assert t["depth"].shape == (1, 200, 260) and torch.isfinite(t["depth"]).all()
    _close(t["depth"], j["depth"])
    _close(t["focallength_px"], j["focallength_px"])


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_tome_proxy_weights_match_jax(merge_inputs, ratio):
    """The speed tiers' checked-in quality-gate proxy (8 blocks, trained on
    structured scenes) through both packages, f_px given (no FOV head)."""
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), j_load_params(PROXY))
    ported = P.load_params(PROXY)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(ported)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    tcfg = dataclasses.replace(chip_smoke.tome_proxy_config(), token_merge_ratio=ratio)
    jcfg = dataclasses.replace(j_tome_proxy_config(), token_merge_ratio=ratio)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    f = np.array([400.0], np.float32)
    t, j = _infer_both(params, x, f, tcfg, jcfg)
    _check_recorded(merge_inputs, 1)
    _close(t["depth"], j["depth"])
