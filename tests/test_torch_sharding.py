"""The port's ``parallel/sharding.py`` and ``parallel/pipeline.py`` against
the JAX package's on the CPU: the TP rules leaf by leaf (the tiny tree and a
quantized one, ``tests/test_parallel.py``'s cases), each tp rank's shard
equal to JAX's addressable shard for its tp index, ``pipeline_blocks`` over a
real gloo group of 2 ranks equal to JAX's under ``shard_map`` on 2 fake
devices with the captures (JAX's own test's inputs, rtol 1e-5 / atol 1e-6),
the gather back, and the JAX package's refusals of parallel degrees."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ml_depth_pro_video_tpu.models import depth_pro as jdp
from ml_depth_pro_video_tpu.models import vit as jvit
from ml_depth_pro_video_tpu.parallel import mesh as jmesh
from ml_depth_pro_video_tpu.parallel import pipeline as jpipeline
from ml_depth_pro_video_tpu.parallel import sharding as jsharding
from ml_depth_pro_video_tpu_torch.ckpt.params import (
    _map_with_path,
    from_numpy_tree,
    init_depth_pro,
    to_numpy_tree,
)
from ml_depth_pro_video_tpu_torch.models import depth_pro as tdp
from ml_depth_pro_video_tpu_torch.parallel import pipeline as tpipeline
from ml_depth_pro_video_tpu_torch.parallel import sharding as tsharding
from ml_depth_pro_video_tpu_torch.parallel.mesh import AxisGroup, Mesh
from ml_depth_pro_video_tpu_torch.train import step as tstep
from torch_ranks import spawn


def _quantized_tree():
    """tests/test_parallel.py::test_tp_rules_cover_quantized_mlp_weights's tree."""
    return {"blocks": {"fc1_w": {"q": np.zeros((2, 8, 16), np.int8),
                                 "s": np.zeros((2, 1, 16), np.float32)},
                       "fc2_w": np.zeros((2, 16, 8), np.float32),
                       "qkv_w": np.zeros((2, 8, 24), np.float32),
                       "proj_w": {"q": np.zeros((2, 8, 8), np.int8),
                                  "s": np.zeros((2, 1, 8), np.float32)}}}


def _tiny_tree():
    """The tiny tree in numpy (the port's initializer builds the JAX package's
    structure; JAX's own takes 20 s of op-by-op compiles here)."""
    return to_numpy_tree(init_depth_pro(tdp.tiny_config(), torch.Generator().manual_seed(0)))


def _specs_by_path(tree, specs):
    out = {}
    _map_with_path(lambda p, leaf: out.setdefault(p, None), tree)
    flat = []
    tsharding._zip_specs(lambda t, s: flat.append(s), tree, specs)
    return dict(zip(out, flat))


@pytest.mark.parametrize("name", ["tiny", "quantized"])
def test_tp_rules_equal_jax_for_every_leaf(name):
    tree = _tiny_tree() if name == "tiny" else _quantized_tree()
    jmesh_ = jmesh.make_mesh(dp=4, tp=2)
    jspecs = jsharding.param_shardings(jax.tree.map(jnp.asarray, tree), jmesh_)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(jspecs)[0]:
        key = tuple(str(getattr(p, "key", getattr(p, "idx", None))) for p in path)
        want[key] = tuple(sh.spec)
    mesh = Mesh(np.arange(8).reshape(4, 2), ("dp", "tp"))
    got = _specs_by_path(tree, tsharding.param_shardings(tree, mesh))
    assert got == want
    assert sum(bool(s) for s in got.values()) == (18 if name == "tiny" else 4)
    # tp = 1, or tensor_parallel=False: every leaf replicated
    one = Mesh(np.arange(8).reshape(8, 1), ("dp", "tp"))
    assert not any(_specs_by_path(tree, tsharding.param_shardings(tree, one)).values())
    assert not any(_specs_by_path(tree, tsharding.param_shardings(tree, mesh, False)).values())


def test_shard_params_equal_jax_addressable_shards():
    """Each tp index's ``shard_params`` equals the data of JAX's addressable
    shard on a device at that tp coordinate (a (4, 2) mesh)."""
    tree = _tiny_tree()
    jm = jmesh.make_mesh(dp=4, tp=2)
    jsharded = jsharding.shard_params(jax.tree.map(jnp.asarray, tree), jm)
    tp_of = {d.id: int(np.argwhere(jm.devices == d)[0][1]) for d in jm.devices.flat}
    ttree = from_numpy_tree(tree)
    for index in (0, 1):
        mesh = Mesh(np.arange(8).reshape(4, 2), ("dp", "tp"),
                    {"tp": AxisGroup(None, (0, 1), index)})
        local = []
        _map_with_path(lambda p, t: local.append((p, t)), tsharding.shard_params(ttree, mesh))
        assert len(local) == len(jax.tree.leaves(jsharded))
        for path, t in local:
            j = jsharded
            for k in path:
                j = j[int(k)] if isinstance(j, list) else j[k]
            shard = next(s for s in j.addressable_shards if tp_of[s.device.id] == index)
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data), err_msg=str(path))


_PIPE_WORKER = r"""
import numpy as np
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.parallel.mesh import Mesh, with_groups
from ml_depth_pro_video_tpu_torch.parallel import pipeline, sharding
inp, out = args
cfg = tiny_config().vit
z = np.load(inp)
blocks = {k[len("blocks/"):]: torch.from_numpy(z[k]) for k in z.files if k.startswith("blocks/")}
mesh = with_groups(pipeline.make_pp_mesh(dp=1, pp=2))
group = mesh.group("pp")
local = {k: v[group.index:group.index + 1].clone() for k, v in blocks.items()}
with torch.no_grad():
    y, caps = pipeline.pipeline_blocks(torch.from_numpy(z["tokens"]), local, cfg, group=group,
                                       microbatches=3, capture_blocks=(0, 1))
# the pp specs' gather rebuilds the stack; the TP rules' shard and gather round-trip too
specs = pipeline._param_specs({"encoder": {"patch_vit": {"blocks": blocks}}})
back = sharding.gather_params({"encoder": {"patch_vit": {"blocks": local}}}, mesh, specs=specs)
same = all(torch.equal(back["encoder"]["patch_vit"]["blocks"][k], v) for k, v in blocks.items())
tp_mesh = with_groups(Mesh(np.arange(2).reshape(1, 2), ("dp", "tp")))
tree = {"blocks": blocks}
round_trip = sharding.gather_params(sharding.shard_params(tree, tp_mesh), tp_mesh)
same_tp = all(torch.equal(round_trip["blocks"][k], v) for k, v in blocks.items())
np.savez(f"{out}/rank{rank}.npz", out=y.numpy(), cap0=caps[0].numpy(), cap1=caps[1].numpy(),
         same=same, same_tp=same_tp)
"""


def test_pipeline_blocks_match_jax(tmp_path):
    """tests/test_parallel.py::test_pipeline_blocks_match_serial_scan's inputs:
    6 token rows of the tiny ViT, 3 microbatches, captures of blocks 0 and 1;
    the port over 2 gloo ranks against JAX's shard_map on 2 fake devices, on
    both stages (the banks are broadcast)."""
    cfg = jdp.tiny_config().vit
    mesh = jpipeline.make_pp_mesh(dp=1, pp=2, devices=jax.devices()[:2])
    params = jvit.init_vit(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(2)
    tokens = rng.standard_normal((6, cfg.num_tokens, cfg.embed_dim)).astype(np.float32)

    def body(tok, blocks_local):
        out, caps = jpipeline.pipeline_blocks(tok, blocks_local, cfg, pp=2, microbatches=3,
                                              capture_blocks=(0, 1))
        return out, tuple(caps)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(), jax.tree.map(lambda _: P("pp"), params["blocks"])),
                   out_specs=(P(), (P(), P())), check_vma=False)
    with mesh:
        jout, (jc0, jc1) = jax.jit(fn)(jnp.asarray(tokens), params["blocks"])
    blocks = {f"blocks/{k}": np.asarray(v) for k, v in params["blocks"].items()}
    np.savez(tmp_path / "inputs.npz", tokens=tokens, **blocks)
    spawn(_PIPE_WORKER, 2, str(tmp_path / "inputs.npz"), str(tmp_path))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["same"] and got["same_tp"]
        for key, want in (("out", jout), ("cap0", jc0), ("cap1", jc1)):
            np.testing.assert_allclose(got[key], np.asarray(want), rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {key}")


def test_pipeline_refusals():
    """The JAX package's refusals: the merge tier, a depth pp does not divide,
    microbatches that do not divide the token rows, a capture past the end."""
    cfg = tdp.tiny_config()
    params = tdp.init_depth_pro(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = Mesh(np.arange(2).reshape(1, 2), ("dp", "pp"))
    merge = dataclasses.replace(cfg, token_merge_ratio=0.5)
    with pytest.raises(ValueError, match="exact path"):
        tpipeline.make_pp_train_step(params, merge, mesh, device="cpu")
    deep = Mesh(np.arange(4).reshape(1, 4), ("dp", "pp"))
    with pytest.raises(ValueError, match="ViT depth 2 not divisible by pp=4"):
        tpipeline.make_pp_train_step(params, cfg, deep, device="cpu")
    group, blocks = AxisGroup(None, (0, 1), 0), params["encoder"]["patch_vit"]["blocks"]
    tokens = torch.zeros(6, cfg.vit.num_tokens, cfg.vit.embed_dim)
    with pytest.raises(ValueError, match="microbatches 4 must divide batch 6"):
        tpipeline.pipeline_blocks(tokens, blocks, cfg.vit, group=group, microbatches=4)
    with pytest.raises(ValueError, match="capture block 5 out of range"):
        tpipeline.pipeline_blocks(tokens, blocks, cfg.vit, group=group, microbatches=2,
                                  capture_blocks=(5,))
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        tpipeline.make_pp_mesh(1, 2)


@pytest.mark.parametrize("kw,match", [
    (dict(tp=4), "tp=4 must divide num_heads=2"),
    (dict(tp=2, pp=2), "pp and tp cannot be combined"),
    (dict(pp=2, grad_accum=2), "grad_accum applies to the DPxTP step"),
])
def test_make_train_step_refusals(kw, match):
    cfg = tdp.tiny_config()
    with pytest.raises(ValueError, match=match):
        tstep.make_train_step({}, cfg, "cpu", **kw)


def test_train_parallel_probe_runs_on_the_cpu(capsys):
    """``scripts/torch_train_parallel_probe.py --device cpu --model tiny`` over 2
    gloo ranks: one rank alone, then dp=2, tp=2 and pp=2, each with its
    collectives per step (tp: 2 sums per block in the forward, the recompute
    and the backward, over 2 ViTs of 2 blocks, and the clipping norm's)."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_train_parallel_probe.py"
    spec = importlib.util.spec_from_file_location("torch_train_parallel_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert probe.main(["--device", "cpu", "--model", "tiny", "--ranks", "2", "--batch", "2",
                       "--steps", "1", "--modes", "dp=2", "tp=2", "pp=2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (res["ranks"], res["backend"]) == (2, "gloo")
    assert res["tp=2 collectives per step"] == {"all_reduce": 2 * 3 * 2 * 2 + 1}
    assert res["pp=2 collectives per step"]["transfer"] == 2 * 5  # 5 microbatches, both ways
    for key in ("one rank samples/s", "dp=2 samples/s", "tp=2 samples/s", "pp=2 samples/s"):
        assert res[key] > 0


_FAIL_WORKER = r"""
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import depth_pro as dp
from ml_depth_pro_video_tpu_torch.train import step as ts
cfg = dp.tiny_config()
params = dp.init_depth_pro(cfg, torch.Generator().manual_seed(0), "cpu")
state, step = ts.make_train_step(params, cfg, "cpu", precision=Precision.fp32(), tp=2)
if rank == 1:
    raise RuntimeError("rank 1 fails before its step")
s = cfg.img_size
step(state, torch.zeros(2, s, s, 3), torch.ones(2, s, s))
print("STEPPED")
"""


def test_a_rank_that_fails_stops_the_group():
    """A tp=2 step whose other rank died: the survivor's first sum over the
    group raises (no collective's failure is caught), so the group stops
    instead of waiting out a timeout."""
    from torch_ranks import run

    (rc0, out0), (rc1, out1) = run(_FAIL_WORKER, 2, timeout=120)
    assert rc1 != 0 and "rank 1 fails" in out1
    assert rc0 != 0 and "STEPPED" not in out0 and "all_reduce" in out0, out0[-2000:]
