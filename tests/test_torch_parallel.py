"""The port's ``parallel/`` inference over real gloo groups of 2 and 3 CPU
ranks, against the JAX package's ``parallel/`` on its 8 fake devices
(``tests/test_parallel.py``'s cases).

Every rank loads the params of one npz (the tiny config, fp32, written by
the JAX package's ``save_params``) and the inputs of one numpy seed. dp
inference is held to the JAX package's ``make_dp_infer`` within its parity
bar (rtol 1e-3 / atol 1e-4); latency inference, exact and at ``--speed
fast``, to the JAX package's ``make_latency_infer`` and to the port's own
unsharded ``infer_fn`` within the JAX test's bar (rtol 2e-3 / atol 1e-5).
Three ranks give ragged patch slices (35 patches pad to 36, the last rank
holds one zero patch) and ragged row bands (8 grid rows as 3, 3, 2). The
halo exchange is held at a band boundary on every decoder level, and the
runner with a dp mesh and in latency mode against the port's one-process
runner.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_depth_pro_video_tpu.core.precision import Precision as JPrecision
from ml_depth_pro_video_tpu.models import depth_pro as jdp
from ml_depth_pro_video_tpu.parallel import latency as jlatency
from ml_depth_pro_video_tpu.parallel import mesh as jmesh
from ml_depth_pro_video_tpu.parallel.spmd import make_dp_infer as j_make_dp_infer
from ml_depth_pro_video_tpu_torch.models.depth_pro import (
    apply_speed,
    infer_fn,
    load_checkpoint,
    tiny_config,
)
from ml_depth_pro_video_tpu_torch.parallel.latency import RowBands, patch_split
from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh, round_batch_to_dp
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint
from torch_ranks import spawn

RTOL, ATOL = 1e-3, 1e-4          # the JAX package's parity bar
LAT_RTOL, LAT_ATOL = 2e-3, 1e-5  # tests/test_parallel.py's latency bar
RUNNER_RTOL, RUNNER_ATOL = 1e-5, 1e-6  # the same kernels' math on fewer rows per call
HALO_ATOL = 1e-5
LEVELS = (2, 4, 8, 16, 32)  # decoder levels, in token grids: fused low-res .. finest

_WORKER = r"""
import dataclasses
import numpy as np
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import depth_pro as dp
from ml_depth_pro_video_tpu_torch.ops.conv import conv2d
from ml_depth_pro_video_tpu_torch.ops.resblock import residual_block_reference
from ml_depth_pro_video_tpu_torch.parallel.latency import RowBands, make_latency_infer, make_sp_mesh
from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh
from ml_depth_pro_video_tpu_torch.parallel.spmd import make_dp_infer
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner

ckpt, out = args
cfg = dataclasses.replace(dp.tiny_config(), checkpoint_uri=ckpt)
fast = dataclasses.replace(dp.apply_speed(cfg, "fast"), token_merge_block=1)
params = dp.load_checkpoint(cfg, "cpu")
inp = np.load(out + "/inputs.npz")
res = {}
with torch.inference_mode():
    o = make_dp_infer(lambda p, x: dp.infer_fn(p, x, None, cfg), make_mesh())(
        params, torch.from_numpy(inp["dp_x"]))
    res["dp_depth"], res["dp_f"] = o["depth"].numpy(), o["focallength_px"].numpy()
    lat = make_latency_infer(cfg)
    x = torch.from_numpy(inp["lat_x"])
    o = lat(params, x)
    res["lat_depth"], res["lat_f"] = o["depth"].numpy(), o["focallength_px"].numpy()
    res["lat321_depth"] = lat(params, x, torch.tensor([321.0]))["depth"].numpy()
    res["fast_depth"] = make_latency_infer(fast)(params, torch.from_numpy(inp["fast_x"]))[
        "depth"].numpy()
    # a band boundary on every decoder level: a 3x3 conv, a residual block and
    # (at the finest level) the head, banded and gathered, against the whole
    bands = RowBands(cfg.vit.grid_size, make_sp_mesh())
    gen = torch.Generator().manual_seed(3)
    c = 8
    w1, w2 = (torch.randn(3, 3, c, c, generator=gen) * 0.2 for _ in range(2))
    b1, b2 = (torch.randn(c, generator=gen) for _ in range(2))
    blk = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
    worst = []
    for k in %(levels)r:
        xl = torch.randn(2, k * cfg.vit.grid_size, 12, c, generator=gen)
        band = bands.take(xl)
        conv = bands.gather(dp._conv3x3(band, w1, b1, bands))
        resb = bands.gather(dp._residual(blk, band, bands))
        worst.append([float((conv - conv2d(xl, w1, b1, padding=1)).abs().max()),
                      float((resb - residual_block_reference(xl, w1, b1, w2, b2)).abs().max()),
                      int(band.shape[1])])
    feats = torch.randn(1, 32 * cfg.vit.grid_size, 12, cfg.decoder_features, generator=gen)
    head = bands.gather(dp.head_apply(params["head"], bands.take(feats), Precision.fp32(), bands))
    res["halo"] = np.asarray(worst)
    res["head_err"] = float((head - dp.head_apply(params["head"], feats)).abs().max())
kw = dict(cfg=cfg, precision="fp32", decode_workers=1, device="cpu")
frames = list(inp["frames"])
runner = DepthVideoRunner(batch_size=2, mesh=make_mesh(), **kw)
res["runner_batch"] = runner.batch_size
res["runner_dp"] = np.stack([r["depth"] for r in runner.depth_stream(frames)])
runner = DepthVideoRunner(batch_size=1, mesh=make_mesh(), parallel="latency", **kw)
res["runner_lat"] = np.stack([r["depth"] for r in runner.depth_stream(frames[:2])])
np.savez(f"{out}/rank{rank}.npz", **res)
print("OK", rank)
""" % {"levels": LEVELS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The npz, the inputs (written for the workers) and the configs."""
    folder = tmp_path_factory.mktemp("parallel")
    ckpt = write_tiny_checkpoint(str(folder / "tiny.npz"))
    rng = np.random.default_rng(0)
    s = tiny_config().img_size
    inputs = {
        "dp_x": rng.uniform(-1, 1, (6, 64, 64, 3)).astype(np.float32),
        "lat_x": rng.standard_normal((1, s, s, 3)).astype(np.float32),
        "fast_x": np.random.default_rng(7).standard_normal((1, s, s, 3)).astype(np.float32),
        "frames": rng.integers(0, 256, (5, 60, 84, 3), dtype=np.uint8),
    }
    np.savez(folder / "inputs.npz", **inputs)
    return {"dir": folder, "ckpt": ckpt, "inputs": inputs,
            "cfg": dataclasses.replace(tiny_config(), checkpoint_uri=ckpt),
            "jcfg": dataclasses.replace(jdp.tiny_config(), checkpoint_uri=ckpt)}


@pytest.fixture(scope="module")
def refs(case):
    """The JAX package's dp and latency programs and the port's unsharded
    ``infer_fn`` on the same params and inputs."""
    inp, jcfg, cfg = case["inputs"], case["jcfg"], case["cfg"]
    jparams = jdp.load_checkpoint(jcfg)
    fp32 = JPrecision.fp32()
    mesh = jmesh.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    jdpi = j_make_dp_infer(lambda p, x: jdp.infer_fn(p, x, None, jcfg, fp32), mesh)
    out = {"jax_dp": np.asarray(jdpi(jparams, jnp.asarray(inp["dp_x"]))["depth"])}
    lat = jlatency.make_latency_infer(jcfg, jlatency.make_sp_mesh(), fp32)
    x = jnp.asarray(inp["lat_x"])
    o = lat(jparams, x)
    out["jax_lat"], out["jax_lat_f"] = np.asarray(o["depth"]), np.asarray(o["focallength_px"])
    out["jax_lat321"] = np.asarray(lat(jparams, x, jnp.array([321.0]))["depth"])
    jfast = dataclasses.replace(jdp.apply_speed(jcfg, "fast"), token_merge_block=1)
    out["jax_fast"] = np.asarray(jlatency.make_latency_infer(jfast, jlatency.make_sp_mesh(), fp32)(
        jparams, jnp.asarray(inp["fast_x"]))["depth"])
    params = load_checkpoint(cfg, "cpu")
    fast = dataclasses.replace(apply_speed(cfg, "fast"), token_merge_block=1)
    with torch.inference_mode():
        x = torch.from_numpy(inp["lat_x"])
        out["port_lat"] = infer_fn(params, x, None, cfg)["depth"].numpy()
        out["port_lat321"] = infer_fn(params, x, torch.tensor([321.0]), cfg)["depth"].numpy()
        out["port_fast"] = infer_fn(params, torch.from_numpy(inp["fast_x"]), None, fast)[
            "depth"].numpy()
        exact = infer_fn(params, torch.from_numpy(inp["fast_x"]), None, cfg)["depth"].numpy()
    # the merged reference itself differs from exact (merging is on)
    assert np.abs(out["port_fast"] - exact).max() > 0
    kw = dict(cfg=cfg, precision="fp32", decode_workers=1, device="cpu")
    frames = list(inp["frames"])
    out["runner"] = np.stack([r["depth"] for r in
                              DepthVideoRunner(batch_size=2, **kw).depth_stream(frames)])
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def ranks(request, case):
    """Every rank's results of the worker, in rank order."""
    n = request.param
    outs = spawn(_WORKER, n, case["ckpt"], case["dir"], timeout=600)
    assert all(f"OK {r}" in o for r, o in enumerate(outs))
    got = []
    for r in range(n):
        with np.load(case["dir"] / f"rank{r}.npz") as z:
            got.append({k: z[k] for k in z.files})
    return got


def test_round_batch_to_dp():
    mesh = make_mesh(dp=4, tp=2, ranks=range(8))
    assert round_batch_to_dp(8, mesh) == 8
    assert round_batch_to_dp(5, mesh) == 8
    assert round_batch_to_dp(1, mesh) == 4
    assert round_batch_to_dp(3, make_mesh(dp=1, tp=8, ranks=range(8))) == 3


def test_make_mesh_rejects_oversubscription():
    with pytest.raises(ValueError):
        make_mesh(tp=2)  # one process: one rank
    with pytest.raises(ValueError):
        make_mesh(tp=16, ranks=range(8))
    mesh = make_mesh(dp=4, tp=2, ranks=range(8))
    assert mesh.shape == {"dp": 4, "tp": 2} and mesh.coords(5) == (2, 1)
    assert make_mesh().shape == {"dp": 1, "tp": 1}


def test_latency_split_arithmetic():
    """The padded patch split and the row bands the workers run on."""
    assert patch_split(35, 2) == (36, 18) and patch_split(35, 3) == (36, 12)
    assert patch_split(70, 3) == (72, 24) and patch_split(35, 5) == (35, 7)
    from ml_depth_pro_video_tpu_torch.parallel.latency import make_sp_mesh

    with pytest.raises(ValueError, match="every rank"):
        RowBands(8, make_sp_mesh(ranks=[0, 1, 2]))  # one process holds only rank 0


def test_dp_inference_matches_jax(ranks, refs):
    for r in ranks:
        np.testing.assert_array_equal(r["dp_depth"], ranks[0]["dp_depth"])
    np.testing.assert_allclose(ranks[0]["dp_depth"], refs["jax_dp"], rtol=RTOL, atol=ATOL)


def test_latency_inference_matches_jax_and_unsharded(ranks, refs):
    for r in ranks:
        np.testing.assert_array_equal(r["lat_depth"], ranks[0]["lat_depth"])
        for ref in (refs["jax_lat"], refs["port_lat"]):
            np.testing.assert_allclose(r["lat_depth"], ref, rtol=LAT_RTOL, atol=LAT_ATOL)
        np.testing.assert_allclose(r["lat_f"], refs["jax_lat_f"], rtol=1e-4)
        for ref in (refs["jax_lat321"], refs["port_lat321"]):
            np.testing.assert_allclose(r["lat321_depth"], ref, rtol=LAT_RTOL, atol=LAT_ATOL)


def test_latency_infer_honors_speed_fast(ranks, refs):
    for r in ranks:
        for ref in (refs["jax_fast"], refs["port_fast"]):
            np.testing.assert_allclose(r["fast_depth"], ref, rtol=LAT_RTOL, atol=LAT_ATOL)


def test_halo_at_band_boundaries_on_every_level(ranks):
    n = len(ranks)
    sizes = [8 // n + (1 if i < 8 % n else 0) for i in range(n)]
    for i, r in enumerate(ranks):
        halo = r["halo"]
        assert [int(h) for h in halo[:, 2]] == [k * sizes[i] for k in LEVELS]
        assert halo[:, :2].max() <= HALO_ATOL, halo
        assert float(r["head_err"]) <= HALO_ATOL


def test_runner_with_dp_mesh_and_latency_mode(ranks, refs):
    n = len(ranks)
    for r in ranks:
        assert int(r["runner_batch"]) == round_batch_to_dp(2, make_mesh(dp=n, ranks=range(n)))
        np.testing.assert_allclose(r["runner_dp"], refs["runner"], rtol=RUNNER_RTOL,
                                   atol=RUNNER_ATOL)
        np.testing.assert_allclose(r["runner_lat"], refs["runner"][:2], rtol=LAT_RTOL,
                                   atol=LAT_ATOL)


def test_parallel_probe_script_runs_on_the_cpu(capsys):
    """``scripts/torch_parallel_probe.py --device cpu --model tiny`` over 2
    gloo ranks: every reading printed, the latency depth equal to one rank's."""
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_parallel_probe.py"
    spec = importlib.util.spec_from_file_location("torch_parallel_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert probe.main(["--device", "cpu", "--model", "tiny", "--ranks", "2", "--frames", "2",
                       "--shape", "60", "80"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (res["ranks"], res["backend"]) == (2, "gloo")
    # 3 token gathers and 2 of the outputs; a halo exchange before each of the 15 3x3 convs
    assert (res["latency all_gather calls per forward"],
            res["latency exchange calls per forward"]) == (5, 15)
    assert (res["latency decoder whole all_gather calls per forward"],
            res["latency decoder whole exchange calls per forward"]) == (3, 0)
    for tag in ("latency", "latency decoder whole"):
        assert res[f"{tag} against one rank max"] <= LAT_RTOL
        assert res[f"{tag} ms per frame"] > 0 and res[f"{tag} all_gather ms per forward"] > 0
    for key in ("one rank batch 1 frames/s", "dp 1 per rank frames/s", "dp 2 per rank frames/s",
                "latency exchange ms per forward"):
        assert res[key] > 0
