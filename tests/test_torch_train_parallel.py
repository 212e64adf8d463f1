"""The port's training step across ranks against the JAX package's one-device
``jax.value_and_grad(train.step.loss_fn)`` on the CPU.

Real gloo groups of 2 ranks (dp=2, tp=2, pp=2) and 4 ranks (dp x tp = 2 x 2,
dp x pp = 2 x 2; ``tests/torch_ranks.py``) run the tiny config in fp32 on one
npz and one global batch of 2, each rank on its rows; the JAX package's
``make_sharded_train_step`` and ``make_pp_train_step`` compute exactly these
(``tests/test_parallel.py``). The head is conditioned as JAX's own test
conditions it (``conv_out`` x0.01, bias 0.5: the canonical map sits near 0.5,
away from the ReLU's 0), and every ViT block's LayerScale is drawn from [1,
2] (at its init of 1e-5 the blocks' branches move nothing downstream, so a
wrong gradient through them, or of them, would hide below any tolerance);
the target is random depth in [1, 10] with a hole on one row only (so the dp
ranks' valid-pixel counts differ). Held: the loss within 1e-5, every
gradient leaf within rtol 2e-3 / atol 2e-6 (the FOV head's, which the loss
skips, None here and zeros in JAX); every leaf that tp or pp splits by its
error relative to its own norm, within 2e-3 (the image ViT's split leaves
are ~1e-6, below the absolute tolerance); and one full clipped AdamW step
against the one-rank port step within rtol 1e-5. The model's gradient puts
~1e-5 of its squared norm on the split ViT blocks, so the global norm is
also held on shared synthetic gradients of every leaf, clipped so far that
the update is linear in the clipped gradient: a split leaf counted once per
rank, or not summed over its group, moves every param (a copy with the norm
taken over the local leaves only fails the tp, pp, dp x tp and dp x pp
cases).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_depth_pro_video_tpu.core.precision import Precision as JPrecision
from ml_depth_pro_video_tpu.models import depth_pro as jdp
from ml_depth_pro_video_tpu.train import step as jstep
from ml_depth_pro_video_tpu_torch.ckpt.params import _map_with_path
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import depth_pro as tdp
from ml_depth_pro_video_tpu_torch.train import step as tstep
from torch_checkpoint import write_tiny_checkpoint
from torch_ranks import spawn

LOSS_ATOL = 1e-5
RTOL, ATOL = 2e-3, 2e-6
STEP_RTOL, STEP_ATOL = 1e-5, 1e-8
LR, CLIP = 1e-2, 1e-7  # CLIP: far below the gradient's norm, so clipping engages
MODES = {2: {"dp": dict(dp=2), "tp": dict(tp=2), "pp": dict(pp=2, microbatches=5)},
         4: {"dp2_tp2": dict(dp=2, tp=2), "dp2_pp2": dict(dp=2, pp=2, microbatches=5)}}

_WORKER = r"""
import dataclasses
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import depth_pro as dp
from ml_depth_pro_video_tpu_torch.parallel.mesh import batch_sharding
from ml_depth_pro_video_tpu_torch.parallel.sharding import gather_leaf, shard_leaf
from ml_depth_pro_video_tpu_torch.train import step as ts
npz, inputs, out, modes = args[0], args[1], args[2], eval(args[3])
cfg = dataclasses.replace(dp.tiny_config(), checkpoint_uri=npz)
z = np.load(inputs)
x, d = torch.from_numpy(z["x"]), torch.from_numpy(z["d"])
res = {}
for name, kw in modes.items():
    state, step = ts.make_train_step(dp.load_checkpoint(cfg, "cpu"), cfg, "cpu", lr=%(lr)r,
                                     precision=Precision.fp32(), clip_norm=%(clip)r, **kw)
    lay = state.layout
    rows = mh.local_rows(batch_sharding(lay.mesh), (x.shape[0],))
    xs, ds = x[rows[0]:rows[-1] + 1], d[rows[0]:rows[-1] + 1]
    loss, grads = ts.value_and_grad(state.params, xs, ds, cfg, Precision.fp32(), lay)
    have = [i for i, g in enumerate(grads) if g is not None]
    full = [gather_leaf(grads[i], lay.leaf_specs[i], lay.mesh) for i in have]
    res[f"{name}/loss"] = float(loss)
    res[f"{name}/have"] = np.asarray(have)
    res[f"{name}/split"] = np.asarray([i for i in have if lay.leaf_specs[i]])
    for i, g in zip(have, full):
        res[f"{name}/g/{i}"] = g.numpy()
    state, step_loss = step(state, xs, ds)
    for i, p in enumerate(ts.tree_leaves(state.to_dict()["params"])):
        res[f"{name}/p/{i}"] = p.numpy()
    res[f"{name}/rows"] = np.asarray(rows)
    # the optimizer alone on shared gradients of every leaf's size, cut to this rank's shard
    state, step = ts.make_train_step(dp.load_checkpoint(cfg, "cpu"), cfg, "cpu", lr=%(lr)r,
                                     precision=Precision.fp32(), clip_norm=%(clip)r, **kw)
    shared = synthetic_grads(ts.tree_leaves(dp.load_checkpoint(cfg, "cpu")), have)
    local = [None if g is None else shard_leaf(g, sp, lay.mesh)
             for g, sp in zip(shared, state.layout.leaf_specs)]
    step.keywords["optimizer"].update(local, state.opt_state, state.params, state.layout)
    for i, p in enumerate(ts.tree_leaves(state.to_dict()["params"])):
        res[f"{name}/shared/{i}"] = p.numpy()
if rank == 0:
    np.savez(out, **res)
print("OK", rank)
"""

# run by the ranks and by this process: the same gradients of every leaf
_SYNTHETIC = r"""
def synthetic_grads(leaves, have):
    # standard normal gradients of every leaf in have (None elsewhere), from
    # one seed: the update clipped to CLIP is linear in them
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)) if i in have
            else None for i, t in enumerate(leaves)]
"""
exec(_SYNTHETIC)
_WORKER = "import numpy as np\n" + _SYNTHETIC + _WORKER % {"lr": LR, "clip": CLIP}


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(npz, inputs npz, JAX's loss, JAX's gradient leaves in the port's
    order, the one-rank port step's params, the directory, the one-rank
    optimizer's params on the shared gradients), for the five modes."""
    tmp = tmp_path_factory.mktemp("train_parallel")
    npz = write_tiny_checkpoint(str(tmp / "tiny.npz"))
    flat = dict(np.load(npz))
    flat["head/conv_out/w"] = flat["head/conv_out/w"] * np.float32(0.01)
    flat["head/conv_out/b"] = np.full_like(flat["head/conv_out/b"], 0.5)
    ls_rng = np.random.default_rng(3)
    for k in flat:
        if k.rsplit("/", 1)[-1] in ("ls1", "ls2"):
            flat[k] = ls_rng.uniform(1, 2, flat[k].shape).astype(np.float32)
    np.savez(npz, **flat)
    jcfg = dataclasses.replace(jdp.tiny_config(), checkpoint_uri=npz)
    tcfg = dataclasses.replace(tdp.tiny_config(), checkpoint_uri=npz)
    rng = np.random.default_rng(0)
    s = jcfg.img_size
    x = rng.random((2, s, s, 3), np.float32)
    d = rng.uniform(1, 10, (2, s, s)).astype(np.float32)
    d[0, :40] = 0.0  # a hole in one row: the ranks' valid counts differ
    np.savez(tmp / "inputs.npz", x=x, d=d)
    # jitted: 7 s on the CPU where the op-by-op gradient takes 50
    jl, jg = jax.jit(jax.value_and_grad(jstep.loss_fn), static_argnums=(3, 4))(
        jdp.load_checkpoint(jcfg), jnp.asarray(x), jnp.asarray(d), jcfg, JPrecision.fp32())
    paths = []
    _map_with_path(lambda p, _: paths.append(p), tdp.load_checkpoint(tcfg, "cpu"))
    jleaves = [_at(jg, p) for p in paths]  # in the port's leaf order
    state, step = tstep.make_train_step(tdp.load_checkpoint(tcfg, "cpu"), tcfg, "cpu", lr=LR,
                                        precision=Precision.fp32(), clip_norm=CLIP)
    _, grads = tstep.value_and_grad(state.params, torch.from_numpy(x), torch.from_numpy(d),
                                    tcfg, Precision.fp32())
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads if g is not None])))
    assert norm > 100 * CLIP, norm
    state, _ = step(state, torch.from_numpy(x), torch.from_numpy(d))
    one_rank = [p.detach().numpy() for p in tstep.tree_leaves(state.params)]
    state, step = tstep.make_train_step(tdp.load_checkpoint(tcfg, "cpu"), tcfg, "cpu", lr=LR,
                                        precision=Precision.fp32(), clip_norm=CLIP)
    have = {i for i, g in enumerate(grads) if g is not None}
    shared = synthetic_grads(tstep.tree_leaves(tdp.load_checkpoint(tcfg, "cpu")), have)
    step.keywords["optimizer"].update(shared, state.opt_state, state.params)
    on_shared = [p.detach().numpy() for p in tstep.tree_leaves(state.params)]
    return npz, str(tmp / "inputs.npz"), float(jl), jleaves, one_rank, tmp, on_shared


@pytest.fixture(scope="module")
def ranks(case):
    npz, inputs, _, _, _, tmp, _ = case
    out = {}
    for n, modes in MODES.items():
        path = str(tmp / f"ranks{n}.npz")
        spawn(_WORKER, n, npz, inputs, path, repr(modes), timeout=600)
        out.update(np.load(path))
    return out


@pytest.mark.parametrize("mode", [m for modes in MODES.values() for m in modes])
def test_parallel_loss_and_gradients_match_jax(case, ranks, mode):
    _, _, jl, jleaves, _, _, _ = case
    assert abs(ranks[f"{mode}/loss"] - jl) < LOSS_ATOL, (ranks[f"{mode}/loss"], jl)
    have = set(ranks[f"{mode}/have"].tolist())
    biggest = 0.0
    for i, want in enumerate(jleaves):
        if i not in have:
            assert not want.any(), i  # the FOV head: no gradient here, zeros in JAX
            continue
        got = ranks[f"{mode}/g/{i}"]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{mode} leaf {i}")
        biggest = max(biggest, float(np.abs(want).max()))
    assert biggest > 1e-2  # the gradients are not vanishingly small
    assert len(have) < len(jleaves)


@pytest.mark.parametrize("mode", ["tp", "pp", "dp2_tp2", "dp2_pp2"])
def test_split_leaf_gradients_match_jax(case, ranks, mode):
    """Each leaf the mode splits (tp: the qkv / proj / fc leaves of the patch
    and image ViTs' blocks; pp: the patch ViT's whole block stack), gathered,
    against JAX's by its error relative to its own norm, which no size of the
    leaf makes vacuous: a missing sum over the tp group in the backward, or a
    microbatch's backward left out, fails here."""
    jleaves = case[3]
    split = ranks[f"{mode}/split"].tolist()
    assert len(split) == (12 if "tp" in mode else 14), split
    for i in split:
        got, want = ranks[f"{mode}/g/{i}"].astype(np.float64), jleaves[i].astype(np.float64)
        norm = np.linalg.norm(want)
        assert norm > 0, i
        rel = np.linalg.norm(got - want) / norm
        assert rel <= RTOL, f"{mode} leaf {i}: relative L2 {rel:.3e}"


@pytest.mark.parametrize("mode", [m for modes in MODES.values() for m in modes])
def test_clipped_adamw_step_equals_one_rank(case, ranks, mode):
    """One full step (loss, gradients, the dp sum, the global norm over the
    split leaves, clipped AdamW on the shards), gathered, against the
    one-rank port step on the whole batch."""
    one_rank = case[4]
    for i, want in enumerate(one_rank):
        np.testing.assert_allclose(ranks[f"{mode}/p/{i}"], want, rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=f"{mode} leaf {i}")


@pytest.mark.parametrize("mode", [m for modes in MODES.values() for m in modes])
def test_clipped_adamw_counts_the_global_norm_once(case, ranks, mode):
    """The optimizer alone on shared gradients of every leaf's size
    (``synthetic_grads``: the model's own put ~1e-5 of the squared norm on
    the split ViT blocks), each rank given its shard: clipped to ``CLIP``,
    far below Adam's eps per element, the update is linear in the clipped
    gradient, so a split leaf counted once per rank, or not summed over its
    group, moves every param."""
    for i, want in enumerate(case[6]):
        np.testing.assert_allclose(ranks[f"{mode}/shared/{i}"], want, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=f"{mode} leaf {i}")
