"""The port's training step (``train/step.py``), loop (``train/loop.py``) and
the ViTs' per-block recompute, held against the JAX package on the CPU.

Both sides run fp32 at ``tiny_config()`` on one npz (``tests/torch_checkpoint.py``)
loaded through ``cfg.checkpoint_uri``. The optimizer is fed the same gradient
sequence on both sides: two correct implementations given gradients computed
independently can differ by 2 lr in an element whose gradient is near 0 (Adam's
first update is +-lr per element), so full steps are not compared by params.

The npz's final head bias is raised by 0.5 for the gradient and fit
comparisons: at random init ~1% of pixels leave the head's ReLU within ulps of
0, where the loss's d/dc log(1/c) = -1/c turns the two frameworks' ulp-level
forward differences (2e-3 relative at c = 1.2e-5) into gradient differences
above rtol 1e-3 in most leaves. Each module's VJP agrees far inside the bound
with a random cotangent (``test_forward_vjp_matches_jax``, raw npz).
"""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ml_depth_pro_video_tpu.core.precision import Precision as JPrecision
from ml_depth_pro_video_tpu.models import depth_pro as jdp
from ml_depth_pro_video_tpu.train import loop as jloop
from ml_depth_pro_video_tpu.train import step as jstep
from ml_depth_pro_video_tpu_torch.ckpt.params import _map_with_path, map_tree
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import depth_pro as tdp
from ml_depth_pro_video_tpu_torch.train import loop as tloop
from ml_depth_pro_video_tpu_torch.train import step as tstep
from ml_depth_pro_video_tpu_torch.utils.synthetic import write_dataset
from torch_checkpoint import write_tiny_checkpoint

import chip_smoke

RTOL, ATOL = 1e-3, 1e-4  # the JAX tests' own bar (tests/test_depth_pro_parity.py)
HEAD_BIAS = 0.5


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


@pytest.fixture(scope="module")
def npz_shifted(tmp_path_factory):
    """The tiny npz with its final head bias raised by HEAD_BIAS, for the one
    comparison that cannot leave pixels out of the loss (two whole ``fit``
    runs): on the raw npz a few canonical pixels sit next to the head's ReLU
    0, where log(1/c) and its gradient turn each package's rounding into
    val_silogs 3.4e-3 apart (relative) after two steps."""
    path = write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny_shifted.npz"))
    flat = dict(np.load(path))
    flat["head/conv_out/b"] = flat["head/conv_out/b"] + np.float32(HEAD_BIAS)
    np.savez(path, **flat)
    return path


def _cfgs(path):
    return (dataclasses.replace(jdp.tiny_config(), checkpoint_uri=path),
            dataclasses.replace(tdp.tiny_config(), checkpoint_uri=path))


def _batch(seed=0, b=2, s=512):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    d = rng.uniform(1, 10, (b, s, s)).astype(np.float32)
    d[0, :9] = 0.0
    d[1, 40:60, 40:60] = np.nan
    d[1, 100:104] = -1.0
    return x, d


def _paths_and_leaves(tree):
    out = []
    _map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("case", ["holes", "nan", "negative", "all_invalid", "clamped"])
def test_silog_loss_matches_jax(case):
    rng = np.random.default_rng(1)
    pred = rng.uniform(0.05, 2.0, (2, 32, 32)).astype(np.float32)
    target = rng.uniform(0.5, 20.0, (2, 32, 32)).astype(np.float32)
    if case == "holes":
        target[0, :5] = 0.0
    elif case == "nan":
        target[1, 3:9, 3:9] = np.nan
        target[0, 0, 0] = np.inf
    elif case == "negative":
        target[:, ::3] = -2.0
    elif case == "all_invalid":
        target[:] = 0.0
    else:  # predictions outside [eps, 1e4]: zeros and huge values
        pred[0, :4] = 0.0
        pred[1, :4] = 1e6
    jl, jg = jax.value_and_grad(jstep.silog_loss)(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    tl = tstep.silog_loss(p, torch.from_numpy(target))
    tl.backward()
    assert np.isfinite(float(tl))
    # fp32 sums of 2048 terms in another order than XLA's: ~1e-6 relative
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


def test_silog_loss_zero_for_perfect_and_masks_holes():
    inv = torch.full((1, 8, 8), 0.5)
    target = 1.0 / inv
    assert float(tstep.silog_loss(inv, target)) < 1e-10
    assert float(tstep.silog_loss(inv * 2, target)) > 1e-3
    target[0, 0, 0], target[0, 1, 1] = 0.0, float("nan")
    assert float(tstep.silog_loss(inv, target)) < 1e-10


# ---------------------------------------------------------------------------
# per-block recompute, the loss's gradients


def test_forward_remat_equals_plain_values_and_gradients(npz):
    _, tcfg = _cfgs(npz)
    params = map_tree(lambda t: t.requires_grad_(), tdp.load_checkpoint(tcfg))
    leaves = [t for _, t in _paths_and_leaves(params)]
    x = torch.from_numpy(_batch()[0])
    out = {}
    for remat in (False, True):
        canonical, _ = tdp.forward(params, x, tcfg, Precision.fp32(), compute_fov=False,
                                   remat=remat)
        grads = torch.autograd.grad(canonical.square().mean(), leaves, allow_unused=True)
        out[remat] = (canonical.detach(), grads)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def _split(v, shapes):
    out, o = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(v[o:o + n].reshape(shape))
        o += n
    return out


def _module_vjp_case(name, jcfg, tcfg):
    """(JAX fn, port fn, JAX params, port params, input, cotangent) of one
    stage of the forward on random numpy inputs."""
    rng = np.random.default_rng(3)
    jp, tp = jdp.load_checkpoint(jcfg), map_tree(lambda t: t.requires_grad_(),
                                                 tdp.load_checkpoint(tcfg))
    if name == "head":
        x = rng.standard_normal((2, 256, 256, 16)).astype(np.float32)
        return (lambda p, v: jdp.head_apply(p, v, JPrecision.fp32()),
                lambda p, v: tdp.head_apply(p, v, Precision.fp32()),
                jp["head"], tp["head"], x, (2, 512, 512, 1))
    shapes = [(2, 256, 256, 16), (2, 128, 128, 16), (2, 64, 64, 32), (2, 32, 32, 64),
              (2, 16, 16, 64)]
    if name == "decoder":
        x = rng.standard_normal(sum(int(np.prod(s)) for s in shapes)).astype(np.float32)
        return (lambda p, v: jdp.decoder_apply(p, _split(v, shapes))[0],
                lambda p, v: tdp.decoder_apply(p, _split(v, shapes))[0],
                jp["decoder"], tp["decoder"], x, shapes[0])
    x = rng.uniform(-1, 1, (2, 512, 512, 3)).astype(np.float32)
    n = sum(int(np.prod(s)) for s in shapes)
    return (lambda p, v: jnp.concatenate([e.reshape(-1) for e in jdp.encoder_apply(
                p, v, jcfg, JPrecision.fp32(), remat=True)]),
            lambda p, v: torch.cat([e.reshape(-1) for e in tdp.encoder_apply(
                p, v, tcfg, Precision.fp32(), remat=True)]),
            jp["encoder"], tp["encoder"], x, (n,))


@pytest.mark.parametrize("name", ["encoder", "decoder", "head"])
def test_forward_stage_vjp_matches_jax(npz, name):
    """Each stage of the forward (the encoder with per-block recompute, the
    decoder, the head) against JAX's ``jax.vjp`` with one random cotangent on
    random inputs, raw npz: the input's and every param leaf's gradient.
    Random inputs keep ReLU pre-activations away from 0; through the whole
    model a unit within ulps of a kink takes the cotangent on one side only."""
    jcfg, tcfg = _cfgs(npz)
    jfn, tfn, jp, tp, x, ct_shape = _module_vjp_case(name, jcfg, tcfg)
    ct = np.random.default_rng(4).standard_normal(ct_shape).astype(np.float32)
    out, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(tp, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=RTOL, atol=ATOL)
    pl = _paths_and_leaves(tp)
    grads = torch.autograd.grad(got, [t for _, t in pl] + [xt], torch.from_numpy(ct),
                                allow_unused=True)
    # a weight gradient sums 1e5-1e6 terms into values of magnitude up to ~300: an element
    # that cancels to ~0.02 carries the sum's absolute rounding, so atol scales with the leaf
    for got_g, want, what in [(grads[-1], np.asarray(jgx), "input")] + [
            (g, _at(jgp, path), str(path)) for (path, _), g in zip(pl, grads[:-1])]:
        if got_g is None:
            assert not want.any(), what
        else:
            np.testing.assert_allclose(got_g.numpy(), want, rtol=RTOL,
                                       atol=ATOL * max(1.0, float(np.abs(want).max())),
                                       err_msg=what)


def test_loss_and_every_gradient_leaf_match_jax(npz):
    """``jax.value_and_grad(loss_fn)`` against the port's on the raw npz.
    The target leaves out the pixels where the two canonical maps differ by
    more than RTOL of their value or sit at the loss's clamp
    (``chip_smoke.conditioned_depth``): there the loss's 1/c gradient is
    ill-conditioned, and on this batch about ten such pixels next to the
    head's ReLU 0 (1e-5 of the batch) move whole leaves past RTOL."""
    jcfg, tcfg = _cfgs(npz)
    x, d = _batch()
    jp = jdp.load_checkpoint(jcfg)
    params = map_tree(lambda t: t.requires_grad_(), tdp.load_checkpoint(tcfg))
    jc, _ = jdp.forward(jp, jnp.asarray(x), jcfg, JPrecision.fp32(), compute_fov=False)
    with torch.no_grad():
        tc, _ = tdp.forward(params, torch.from_numpy(x), tcfg, Precision.fp32(), compute_fov=False)
    target, left_out = chip_smoke.conditioned_depth(
        torch.from_numpy(d), [torch.from_numpy(np.asarray(jc)[..., 0]), tc[..., 0]], RTOL)
    assert 0 < left_out < 0.05, left_out  # the clamped pixels, and a few next to them
    d = target.numpy()
    jl, jg = jax.value_and_grad(jstep.loss_fn)(jp, jnp.asarray(x), jnp.asarray(d), jcfg,
                                               JPrecision.fp32())
    tl, grads = tstep.value_and_grad(params, torch.from_numpy(x), torch.from_numpy(d), tcfg,
                                     Precision.fp32())
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    unreached = []
    for (path, _), g in zip(_paths_and_leaves(params), grads):
        want = _at(jg, path)
        if g is None:
            # a leaf the loss does not reach: no gradient here, exact zeros in JAX
            assert not want.any(), path
            unreached.append(path)
        else:
            assert path[0] != "fov", path
            np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=str(path))
    # the FOV head (the loss skips it) and the last fusion's unused res1
    fov = [p for p in unreached if p[0] == "fov"]
    assert fov and len(unreached) == len(fov) + 4, unreached


# ---------------------------------------------------------------------------
# the optimizer on shared gradients, against the optax chain

def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((4, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal(5) * scale).astype(np.float32),
            "fov": {"w": (rng.standard_normal((3, 3)) * scale).astype(np.float32)}}


OPT_CASES = {
    "constant_lr": dict(lr=1e-2, weight_decay=1e-2, total_steps=None, warmup_steps=0,
                        clip_norm=None, grad_accum=1, scale=1.0),
    "warmup_0": dict(lr=1e-2, weight_decay=1e-2, total_steps=8, warmup_steps=0,
                     clip_norm=None, grad_accum=1, scale=1.0),
    "warmup_3": dict(lr=1e-2, weight_decay=1e-2, total_steps=8, warmup_steps=3,
                     clip_norm=None, grad_accum=1, scale=1.0),
    "warmup_truncated": dict(lr=1e-2, weight_decay=1e-2, total_steps=8, warmup_steps=100,
                             clip_norm=None, grad_accum=1, scale=1.0),
    "clip_active": dict(lr=1e-2, weight_decay=1e-2, total_steps=8, warmup_steps=2,
                        clip_norm=1.0, grad_accum=1, scale=10.0),
    "clip_inactive": dict(lr=1e-2, weight_decay=1e-2, total_steps=8, warmup_steps=2,
                          clip_norm=1.0, grad_accum=1, scale=0.01),
    "grad_accum_2": dict(lr=1e-2, weight_decay=1e-2, total_steps=8, warmup_steps=2,
                         clip_norm=1.0, grad_accum=2, scale=1.0),
    "grad_accum_3": dict(lr=1e-2, weight_decay=1e-2, total_steps=9, warmup_steps=3,
                         clip_norm=1.0, grad_accum=3, scale=0.3),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizer_matches_optax_on_shared_gradients(name):
    """Eight data batches of numpy gradients through the JAX package's
    ``make_optimizer`` and the port's; the FOV leaf gets no gradient on the
    port's side (zeros in JAX's, as its loss leaves them) and must be decayed
    alike. fp32 on both sides: the same formulas in the same order, so the
    params agree to a few ulps (rtol 1e-5)."""
    c = dict(OPT_CASES[name])
    scale = c.pop("scale")
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    tx = jstep.make_optimizer(**c)
    opt = tstep.make_optimizer(**c)
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    tp = map_tree(lambda a: torch.from_numpy(a.copy()), p0)
    ts = opt.init(tp)
    paths = [p for p, _ in _paths_and_leaves(tp)]
    applied = 0
    for i in range(8):
        g = _tree(rng, scale)
        g["fov"]["w"][:] = 0.0
        up, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, up)
        tg = [None if p[0] == "fov" else torch.from_numpy(_at(g, p).copy()) for p in paths]
        applied += opt.update(tg, ts, tp)
        for key in ("w", "b"):
            np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} batch {i} {key}")
        np.testing.assert_allclose(tp["fov"]["w"].numpy(), np.asarray(jp["fov"]["w"]),
                                   rtol=1e-5, atol=1e-7, err_msg=f"{name} batch {i} fov")
    assert applied == 8 // c["grad_accum"] == ts.count
    if c["weight_decay"] and c["total_steps"] is not None:
        # decayed without a gradient: the FOV leaf moved toward 0
        assert np.abs(tp["fov"]["w"].numpy()).sum() < np.abs(p0["fov"]["w"]).sum()


def _optax_schedule(lr, warmup_steps, total_steps, grad_accum):
    """The schedule the JAX package's make_optimizer builds, by its own
    conversion of data batches to updates."""
    total_updates = max(total_steps // grad_accum, 1)
    warmup_updates = -(-max(warmup_steps, 0) // grad_accum)
    if warmup_updates >= total_updates:
        warmup_updates = max(total_updates - 1, 0)
    if warmup_updates == 0:
        return optax.cosine_decay_schedule(init_value=lr, decay_steps=total_updates)
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup_updates,
        decay_steps=max(total_updates, warmup_updates + 1))


@pytest.mark.parametrize("lr,warmup,total,accum", [
    (1e-4, 0, 12, 1), (1e-4, 5, 12, 1), (3e-4, 100, 12, 1), (1e-3, 5, 12, 2), (1e-3, 4, 13, 3),
    (2e-4, 1, 1, 1), (1e-4, 7, 40, 1)])
def test_schedule_values_match_optax_at_every_count(lr, warmup, total, accum):
    opt = tstep.make_optimizer(lr, warmup_steps=warmup, total_steps=total, grad_accum=accum)
    want = _optax_schedule(lr, warmup, total, accum)
    for count in range(total // accum + 3):
        np.testing.assert_allclose(opt.lr(count), float(want(jnp.asarray(count, jnp.int32))),
                                   rtol=1e-6, atol=1e-12, err_msg=f"count {count}")


def test_warmup_longer_than_run_truncates_with_a_warning(caplog):
    with caplog.at_level(logging.WARNING, logger="ml_depth_pro_video_tpu_torch.train.step"):
        opt = tstep.make_optimizer(lr=1e-2, warmup_steps=1000, total_steps=20)
    assert any("truncating warmup" in r.message for r in caplog.records)
    # warmup over 19 of the 20 updates, then a one-update cosine from the peak
    assert opt.lr(18) == pytest.approx(1e-2 * 18 / 19, rel=1e-6)
    assert opt.lr(19) == pytest.approx(1e-2, rel=1e-6) and opt.lr(20) == 0.0
    # a one-update run trains at the peak LR, not at warmup's 0
    assert tstep.make_optimizer(lr=1e-2, warmup_steps=100, total_steps=1).lr(0) == \
        pytest.approx(1e-2)
    with pytest.raises(ValueError, match="grad_accum"):
        tstep.make_optimizer(lr=1e-2, grad_accum=0)


def test_grad_accum_counts_data_batches_and_updates_apart(npz):
    """state.step counts data batches; the optimizer's count (the schedule's)
    counts applied updates; params move only at the k-th batch."""
    _, tcfg = _cfgs(npz)
    state, step = tstep.make_train_step(tdp.load_checkpoint(tcfg), tcfg, "cpu", lr=1e-3,
                                        precision=Precision.fp32(), grad_accum=2)
    x, d = (torch.from_numpy(a) for a in _batch(3))
    before = tstep.tree_leaves(state.params)[0].detach().clone()
    state, loss = step(state, x, d)
    assert state.step == 1 and state.opt_state.count == 0 and np.isfinite(float(loss))
    assert torch.equal(tstep.tree_leaves(state.params)[0], before)
    state, _ = step(state, x, d)
    assert state.step == 2 and state.opt_state.count == 1
    assert not torch.equal(tstep.tree_leaves(state.params)[0], before)


@pytest.mark.parametrize("kw,match", [
    (dict(dp=2), "mesh 2x1 needs 2 devices, have 1"),
    (dict(tp=4), "tp=4 must divide num_heads=2"),
    (dict(pp=4), "mesh 1x4 needs 4 devices, have 1")])
def test_multi_device_step_refusals(kw, match):
    """In one process a mesh larger than the group, and a tp that does not
    divide the heads, raise the JAX package's ValueErrors (the working
    multi-rank steps: tests/test_torch_train_parallel.py)."""
    with pytest.raises(ValueError, match=match):
        tstep.make_train_step({}, tdp.tiny_config(), "cpu", **kw)


# ---------------------------------------------------------------------------
# the loop


def test_fit_matches_jax_fit(npz_shifted, tmp_path):
    """Both packages' fit on one dataset and npz: per-step losses from the
    metrics files and the final val_silog within rtol 1e-3."""
    jcfg, tcfg = _cfgs(npz_shifted)
    data = tmp_path / "data"
    write_dataset(str(data), 5, seed=3, size=64)
    kw = dict(batch_size=2, epochs=1, lr=1e-4, warmup_steps=1, holdout=1, log_every=1, seed=0)
    jm, tm = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    jstate = jloop.fit(str(data), jcfg, precision=JPrecision.fp32(), dp=1,
                       metrics_file=str(jm), **kw)
    tstate = tloop.fit(str(data), tcfg, precision=Precision.fp32(), device="cpu",
                       metrics_file=str(tm), **kw)
    assert int(jstate.step) == tstate.step == 2
    jr = [json.loads(line) for line in jm.read_text().splitlines()]
    tr = [json.loads(line) for line in tm.read_text().splitlines()]
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    for a, b in zip(tr, jr):
        assert a["step"] == b["step"]
        for key in ("loss", "val_silog", "lr_progress"):
            if key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=RTOL, err_msg=key)
    assert any("val_silog" in r for r in tr)


def test_validate_excludes_batches_without_valid_pixels(tmp_path):
    from PIL import Image

    cfg = tdp.tiny_config()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8)).save(tmp_path / "good.png")
    np.save(tmp_path / "good_depth.npy", rng.uniform(1.0, 5.0, (32, 32)).astype(np.float32))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    np.save(tmp_path / "bad_depth.npy", rng.uniform(1.0, 5.0, (32, 32)).astype(np.float32))
    params = tdp.build_params(cfg, "cpu", 0)
    good = [(str(tmp_path / "good.png"), str(tmp_path / "good_depth.npy"))]
    both = good + [(str(tmp_path / "bad.png"), str(tmp_path / "bad_depth.npy"))]
    v_good = tloop._validate(params, good, cfg, Precision.fp32(), 1, "cpu")
    v_both = tloop._validate(params, both, cfg, Precision.fp32(), 1, "cpu")
    assert np.isfinite(v_good) and v_good > 0
    assert v_both == pytest.approx(v_good)


def test_train_cli_on_the_cpu(tmp_path):
    data = tmp_path / "data"
    write_dataset(str(data), 3, seed=1, size=64)
    metrics, ckpt = tmp_path / "m.jsonl", tmp_path / "ckpt"
    tloop.main(["--data_root", str(data), "--tiny", "--device", "cpu", "--batch_size", "2",
                "--warmup_steps", "0", "--log_every", "1", "--metrics_file", str(metrics),
                "--checkpoint_dir", str(ckpt), "--save_every", "1"])
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1] and np.isfinite(rows[0]["loss"])
    assert (ckpt / "1" / "state.pt").is_file()


@pytest.mark.parametrize("kw,match", [
    (dict(tp=2), "mesh 0x2 needs 2 devices, have 1"),
    (dict(pp=2), "pp=2 needs at least 2 devices, have 1"),
    (dict(dp=2), "mesh 2x1 needs 2 devices, have 1"),
    (dict(pp=2, tp=2), "pp and tp cannot be combined"),
    (dict(pp=2, grad_accum=2), "grad_accum applies to the DPxTP step")])
def test_fit_parallel_refusals(tmp_path, kw, match):
    """The JAX package's ValueErrors of ``fit``, raised before the data is
    read (the directory is empty)."""
    with pytest.raises(ValueError, match=match):
        tloop.fit(str(tmp_path), tdp.tiny_config(), device="cpu", **kw)


@pytest.mark.parametrize("flags,want", [
    (["--num_processes", "2", "--process_id", "0"], "--coordinator"),
    (["--coordinator", "127.0.0.1:1", "--num_processes", "1", "--process_id", "0"], {}),
    (["--pp", "2", "--microbatches", "7"], {"pp": 2, "microbatches": 7})])
def test_train_cli_multi_host_flags(flags, want, tmp_path, monkeypatch):
    """The multi-host flags join a group before any device use: several
    processes need a coordinator; one process joins none and trains alone;
    the parallel degrees reach ``fit`` (a stub here; the 2-rank CLI runs:
    tests/test_torch_fit_parallel.py)."""
    from ml_depth_pro_video_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(tloop, "fit", lambda *a, **kw: calls.append(kw))
    argv = ["--data_root", str(tmp_path), "--tiny", "--device", "cpu", *flags]
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tloop.main(argv)
        assert not calls
        return
    tloop.main(argv)
    assert multihost.cluster() is None and len(calls) == 1
    assert {k: calls[0][k] for k in want} == want


def test_fit_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.fit(str(tmp_path), tdp.tiny_config())
