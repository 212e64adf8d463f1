"""The port's ``parallel/multihost.py`` and the paths built on it, over real
gloo groups of 2 CPU ranks (``tests/test_multihost.py``'s cases).

Single-process every helper is the identity. Over 2 ranks: rows, the
broadcasts, ``any_flag``, the ragged ``all_gather``, ``exchange`` and the
barrier; ``depth_stream_multihost`` against the JAX package's single-process one on
a dp mesh of its fake devices (the same frames, indices and depths within
the parity bar rtol 1e-3 / atol 1e-4), an unreadable frame, lazy
consumption, a stop at a batch boundary and the contract errors; the maps
and pipeline CLIs over 2 ranks, whose files equal what the JAX package
writes (the maps within the parity bar and ``PNG_LEVELS``; the ground plane
within ``GROUND_ATOL`` and the plans within ``PNG_SHARE``, as
``tests/test_torch_pipeline.py`` compares them); ``create_server`` with
``parallel="dp"`` over 2 ranks against one rank's server; and a ``--dp 2``
artifact served by a 2-rank runner. Every rank loads the params of one npz
(tiny config, fp32).
"""

import dataclasses
import json
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from ml_depth_pro_video_tpu.cli import generate_depth_maps as jmaps
from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.parallel.mesh import make_mesh as j_make_mesh
from ml_depth_pro_video_tpu.video import pipeline as jpipeline
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.ckpt.export import main as export_main
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.parallel import multihost as mh
from ml_depth_pro_video_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from ml_depth_pro_video_tpu_torch.serve.server import create_server
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint
from torch_ranks import free_port, run, spawn

RTOL, ATOL = 1e-3, 1e-4
PNG_LEVELS = 2e-3   # share of a depth PNG's range (tests/test_torch_maps_cli.py)
GROUND_ATOL = 1e-5  # tests/test_torch_pipeline.py
PNG_SHARE = 1e-3    # of a plan's pixels that may differ between the packages
SERVE_RTOL = 1e-5   # the same math on 2 rows per rank against 4 on one rank


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


def _synthetic_frames(n, h=48, w=64, seed=3):
    """``tests/test_multihost.py``'s frames: one base, a moving bright box."""
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    frames = []
    for i in range(n):
        f = base.copy()
        f[10:20, 4 + 3 * i:14 + 3 * i] = 255
        frames.append(f)
    return frames


def _port_runner(checkpoint, **kwargs):
    return DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                            precision="fp32", decode_workers=1, device="cpu", **kwargs)


def _jax_runner(checkpoint, **kwargs):
    return JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint),
                     precision="fp32", decode_workers=1, **kwargs)


# ---------------------------------------------------------------------------
# single process: the identity


def test_single_process_identity(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mh.initialize() is False and mh.cluster() is None
    sh = batch_sharding(make_mesh())
    assert mh.local_rows(sh, (16, 4)) == list(range(16))
    assert mh.rows_for_process(sh, (16, 4), process_index=1) == []  # no other rank
    x = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    vals, rows = mh.local_output(x, sh, 16)
    assert rows == list(range(16))
    np.testing.assert_array_equal(vals, x.numpy())
    assert mh.is_primary() and mh.world_size() == 1 and mh.rank() == 0
    mh.barrier()  # no-op
    assert mh.broadcast_from_primary({"a": 3})["a"] == 3
    assert mh.broadcast_json({"b": [1.5]}) == {"b": [1.5]}
    assert mh.all_gather(x)[0] is x
    assert mh.exchange({}) == {}


def test_any_flag_single_process_identity():
    assert mh.any_flag(True) is True
    assert mh.any_flag(False) is False


def test_local_item_count_single_process_is_n_items():
    sh = batch_sharding(make_mesh())
    for n in (0, 1, 7, 8, 9, 23):
        assert mh.local_item_count(sh, 8, n) == n


def test_rows_respect_mesh_layout():
    # tp replicates rows: ranks (i, 0) and (i, 1) hold the same dp block
    sh = batch_sharding(make_mesh(dp=4, tp=2, ranks=range(8)))
    assert [mh.rows_for_process(sh, (8, 3), r) for r in range(8)] == [
        [0, 1], [0, 1], [2, 3], [2, 3], [4, 5], [4, 5], [6, 7], [6, 7]]
    with pytest.raises(ValueError, match="round_batch_to_dp"):
        mh.rows_for_process(sh, (6, 3), 0)


def test_make_pod_mesh_rejects_straddling_tp(monkeypatch):
    monkeypatch.setattr(mh, "local_world_size", lambda: 8)
    with pytest.raises(ValueError, match="straddle"):
        mh.make_pod_mesh(dp=1, tp=3)  # 8 ranks per host, 3 does not tile


def test_backend_rule():
    assert mh.choose_backend("cpu", [2], [0])[0] == "gloo"
    assert mh.choose_backend("cuda", [2], [1])[0] == "gloo"  # two ranks share one card
    assert mh.choose_backend("cuda", [4, 4], [4, 8])[0] == "nccl"
    assert mh.choose_backend("cuda", [4, 4], [4, 2])[0] == "gloo"  # one short host decides


def test_multihost_stream_contract_errors(checkpoint):
    r = _port_runner(checkpoint, batch_size=2)
    with pytest.raises(ValueError, match="dp mesh"):
        next(r.depth_stream_multihost([np.zeros((48, 64, 3), np.uint8)]))
    for kwargs, match in (({"temporal_smooth": 0.5}, "temporal_smooth"),
                          ({"fetch_pack": "u16"}, "fetch_pack")):
        r = _port_runner(checkpoint, batch_size=2, mesh=make_mesh(), **kwargs)
        with pytest.raises(ValueError, match=match):
            next(r.depth_stream_multihost([np.zeros((48, 64, 3), np.uint8)]))


def test_multihost_stream_single_process_matches_depth_stream(checkpoint):
    r = _port_runner(checkpoint, batch_size=4, mesh=make_mesh())
    frames = _synthetic_frames(6)
    got = list(r.depth_stream_multihost(frames))
    assert [g["index"] for g in got] == list(range(6))
    for g, w in zip(got, r.depth_stream(frames), strict=True):
        np.testing.assert_array_equal(g["depth"], w["depth"])
        assert g["focallength_px"] == w["focallength_px"]


# ---------------------------------------------------------------------------
# two ranks


_CLUSTER_WORKER = r"""
import numpy as np
from ml_depth_pro_video_tpu_torch.parallel.mesh import batch_sharding, make_mesh
c = mh.cluster()
assert (c.backend, c.world, c.local_world, c.hosts, c.local_rank) == ("gloo", n, n, 1, rank), c
assert mh.initialize(f"127.0.0.1:{port}", n, rank, device="cpu") is True  # idempotent
sh = batch_sharding(make_mesh(dp=2))
rows = mh.local_rows(sh, (8, 3))
assert rows == list(range(4 * rank, 4 * rank + 4)), rows
assert mh.rows_for_process(sh, (8, 3), 1 - rank) != rows
vals, orows = mh.local_output(torch.arange(4.0) + 4 * rank, sh, 8)
assert orows == rows and vals.tolist() == [float(r) for r in rows]
assert mh.broadcast_from_primary(np.float32(7 + rank)) == 7.0  # rank 0's value everywhere
assert mh.broadcast_text("héllo" * 100 if rank == 0 else None) == "héllo" * 100
val = 0.1234567890123456789
obj = mh.broadcast_json({"d": val, "names": ["a.png", "b.png"],
                         "normal": np.asarray([0.0, 1.0, val])} if rank == 0 else None)
assert obj["d"] == val and obj["names"] == ["a.png", "b.png"] and obj["normal"][2] == val
assert mh.any_flag(rank == 1) is True
assert mh.any_flag(False) is False
# rank 0 holds rows {0, 1}, rank 1 rows {2, 3}; 6 items in batches of 4 put 4, 5 on rank 0
assert mh.local_item_count(sh, 4, 6) == (4 if rank == 0 else 2)
pieces = mh.all_gather(torch.full((2, 3), float(rank)))
assert [p.tolist() for p in pieces] == [[[0.0] * 3] * 2, [[1.0] * 3] * 2]
ragged = mh.all_gather(torch.full((rank + 1, 2), rank + 0.5, dtype=torch.bfloat16),
                       shapes=[(1, 2), (2, 2)])
assert [tuple(p.shape) for p in ragged] == [(1, 2), (2, 2)]
assert ragged[1].dtype == torch.bfloat16 and ragged[1].float().tolist() == [[1.5, 1.5]] * 2
# point to point with the other rank: its tensor comes back, in its dtype
got = mh.exchange({1 - rank: torch.full((1, 2, 3), rank + 0.25, dtype=torch.bfloat16)})
assert list(got) == [1 - rank] and got[1 - rank].dtype == torch.bfloat16
assert got[1 - rank].float().tolist() == [[[1 - rank + 0.25] * 3] * 2]
mh.barrier("test")
print(f"WORKER{rank}_OK", flush=True)
"""


def test_two_rank_cluster():
    outs = spawn(_CLUSTER_WORKER, 2)
    for r, out in enumerate(outs):
        assert f"WORKER{r}_OK" in out


_STREAM_WORKER = r"""
import dataclasses, json
import numpy as np
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
ckpt, folder = args
frames = list(np.load(folder + "/frames.npy"))
kw = dict(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=ckpt), precision="fp32",
          batch_size=4, mesh=make_mesh(), decode_workers=1, device="cpu")
r = DepthVideoRunner(**kw)
got = list(r.depth_stream_multihost(frames[:6]))
np.savez(f"{folder}/stream{rank}.npz", index=[g["index"] for g in got],
         depth=np.stack([g["depth"] for g in got]), f=[g["focallength_px"] for g in got])
# an unreadable frame: zero-substituted, its row kept, never yielded
items = [frames[0], "/no/such/frame.png", frames[2], frames[3]]
bad = list(r.depth_stream_multihost(items))
# lazy consumption: one batch in flight and the one being decoded, never the whole list
consumed = []
def gen():
    for i, f in enumerate(frames):
        consumed.append(i)
        yield f
lazy = DepthVideoRunner(**{**kw, "pipeline_depth": 1})
stream = lazy.depth_stream_multihost(gen())
first = next(stream)
n_first = len(consumed)
rest = [o["index"] for o in stream]
# a stop at a batch boundary, raised on rank 1 only: every rank stops together
none = list(lazy.depth_stream_multihost(frames, should_stop=lambda: True))
stop = {"flag": False}
stopped = []
for o in lazy.depth_stream_multihost(frames, should_stop=lambda: stop["flag"]):
    stopped.append(o["index"])
    stop["flag"] = rank == 1
print("RESULT " + json.dumps({"bad": [o["index"] for o in bad], "first": first["index"],
                              "n_first": n_first, "lazy": [first["index"]] + rest,
                              "none": none, "stopped": stopped}), flush=True)
"""


def test_two_rank_stream_matches_jax(checkpoint, tmp_path):
    """The union of the ranks' rows is every frame once, with the JAX
    package's depth and f_px for it (its single-process stream on a dp=4
    mesh of fake devices), plus the stream's isolation, laziness and stop."""
    frames = _synthetic_frames(16)
    np.save(tmp_path / "frames.npy", np.stack(frames))
    outs = spawn(_STREAM_WORKER, 2, checkpoint, tmp_path, timeout=600)
    res = [json.loads(re.search(r"^RESULT (.*)$", o, re.M).group(1)) for o in outs]
    mesh = j_make_mesh(dp=4, tp=1, devices=jax.devices()[:4])
    ref = {o["index"]: o for o in _jax_runner(checkpoint, batch_size=4, mesh=mesh)
           .depth_stream_multihost(frames[:6])}
    seen = set()
    for r in range(2):
        with np.load(tmp_path / f"stream{r}.npz") as z:
            assert not seen & set(z["index"].tolist())
            seen |= set(z["index"].tolist())
            for idx, depth, f in zip(z["index"], z["depth"], z["f"]):
                np.testing.assert_allclose(depth, ref[int(idx)]["depth"], rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(f, ref[int(idx)]["focallength_px"], rtol=RTOL)
    assert sorted(seen) == list(range(6))
    # rank 0 holds rows {0, 1} of each batch of 4, rank 1 rows {2, 3}
    assert res[0]["bad"] == [0] and res[1]["bad"] == [2, 3]
    assert [res[r]["first"] for r in range(2)] == [0, 2]
    assert all(res[r]["n_first"] <= 12 for r in range(2))
    assert sorted(res[0]["lazy"] + res[1]["lazy"]) == list(range(16))
    assert res[0]["none"] == res[1]["none"] == []
    # batch 0 (yielding) and batch 1 (in flight at pipeline_depth 1) drain; batch 2 never runs
    assert sorted(res[0]["stopped"] + res[1]["stopped"]) == list(range(8))


_MAPS_WORKER = r"""
import dataclasses
from ml_depth_pro_video_tpu_torch.cli import generate_depth_maps as maps
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
ckpt, frames, out = args
maps.model_preset = lambda name: dataclasses.replace(tiny_config(), checkpoint_uri=ckpt)
maps.main([frames, "-o", out, "--model", "tiny", "--full_precision", "--batch_size", "4",
           "--save_npz", "--colormap", "gray16", "--device", "cpu",
           "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(n),
           "--process_id", str(rank)])
print(f"WORKER{rank}_OK", flush=True)
"""


def test_two_rank_maps_cli(checkpoint, tmp_path):
    """``depth-pro-maps-torch`` over 2 ranks: every frame written once, by the
    rank holding its row, and the files are what the JAX package writes."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate(_synthetic_frames(6)):
        Image.fromarray(f).save(frames / f"f{i:03d}.png")
    out = tmp_path / "depth"
    outs = spawn(_MAPS_WORKER, 2, checkpoint, frames, out, join=False, timeout=600)
    counts = []
    for r, o in enumerate(outs):
        assert f"WORKER{r}_OK" in o and f"[rank {r}/2] wrote" in o
        counts.append(int(re.search(r"wrote (\d+) of this rank's rows", o).group(1)))
    assert counts == [4, 2]  # rows {0, 1} of both batches, rows {2, 3} of the first
    want = tmp_path / "jax"
    jmaps.generate_depth_maps(str(frames), str(want), colormap="gray16", save_npz=True,
                              runner=_jax_runner(checkpoint, batch_size=4))
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(p.name for p in want.iterdir()) and len(names) == 12
    for name in names:
        if name.endswith(".png"):
            got = np.asarray(Image.open(out / name)).astype(np.int64)
            ref = np.asarray(Image.open(want / name)).astype(np.int64)
            assert np.abs(got - ref).max() <= max(1, PNG_LEVELS * 65535), name
        else:
            with np.load(out / name) as g, np.load(want / name) as w:
                np.testing.assert_allclose(g["depth"], w["depth"], rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(g["focallength_px"], w["focallength_px"], rtol=RTOL)


_PIPELINE_WORKER = r"""
import dataclasses
from ml_depth_pro_video_tpu_torch.cli import pipeline as cli
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.video import pipeline
ckpt, frames, out = args
pipeline.model_preset = lambda name: dataclasses.replace(tiny_config(), checkpoint_uri=ckpt)
cli.main(["--frames_dir", frames, "--output_dir", out, "--model", "tiny", "--full_precision",
          "--batch_size", "4", "--no_fit_shapes", "--output_main_only", "--renderer", "fast",
          "--num_workers", "1", "--pattern", "cam1/output_*.png", "--device", "cpu",
          "--parallel", "latency", "--coordinator", f"127.0.0.1:{port}",
          "--num_processes", str(n), "--process_id", str(rank)])
print(f"WORKER{rank}_OK", flush=True)
"""


def test_two_rank_pipeline_cli(checkpoint, tmp_path):
    """``depth-pro-video-torch`` over 2 ranks with frames in a subdirectory:
    the ground fitted once (rank 0) and cached, each rank's own progress
    file, their union every frame once, and the plans and ground plane what
    the JAX package's pipeline writes from the same frames."""
    frames = tmp_path / "frames"
    (frames / "cam1").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        img = (rng.random((120, 160, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(frames / "cam1" / f"output_{i:04d}.png")
    jax_frames = tmp_path / "jax_frames"
    shutil.copytree(frames, jax_frames)
    out = tmp_path / "plans"
    outs = spawn(_PIPELINE_WORKER, 2, checkpoint, frames, out, join=False, timeout=600)
    for r, o in enumerate(outs):
        assert f"WORKER{r}_OK" in o
    assert "--parallel latency is single-host only; using pod-wide dp" in outs[0]
    assert outs[0].count("Computing ground plane") == 1 and "Computing" not in outs[1]
    plans = sorted(p.name for p in out.glob("*_clean_simple_view.png"))
    assert plans == [f"output_{i:04d}_clean_simple_view.png" for i in range(4)]
    done = [set(json.load(open(out / f"processing_progress{s}.json"))) for s in ("", ".p1")]
    assert not (done[0] & done[1])
    assert done[0] | done[1] == {f"output_{i:04d}.png" for i in range(4)}

    want = tmp_path / "jax_plans"
    jpipeline.process_images_to_floor_plans(
        str(jax_frames), output_dir=str(want), pattern="cam1/output_*.png", fit_shapes=False,
        output_all_files=False, renderer="fast", num_workers=1,
        runner=_jax_runner(checkpoint, batch_size=4))
    grounds = [json.load(open(f / "ground.json")) for f in (jax_frames, frames)]
    for key in ("normal", "d", "origin"):
        np.testing.assert_allclose(grounds[1][key], grounds[0][key], rtol=0, atol=GROUND_ATOL)
    for name in plans:
        got = np.asarray(Image.open(out / name))
        ref = np.asarray(Image.open(want / name))
        assert got.shape == ref.shape, name
        assert np.mean(np.any(got != ref, axis=-1)) <= PNG_SHARE, name


_SERVE_WORKER = r"""
import base64, dataclasses, io, json, threading, urllib.request
from concurrent.futures import ThreadPoolExecutor
import numpy as np
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh
from ml_depth_pro_video_tpu_torch.serve.server import FollowerServer, create_server
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
ckpt, folder = args
runner = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=ckpt),
                          precision="fp32", batch_size=4, mesh=make_mesh(), decode_workers=1,
                          decode_pool="thread", device="cpu")
server = create_server(port=0, runner=runner, parallel="dp", max_batch=4, max_wait_ms=500)
if rank:
    assert isinstance(server, FollowerServer)
    server.serve_forever()  # until rank 0's server closes
    print(f"FOLLOWED {server.batches}", flush=True)
else:
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d/v1/depth?return=npz" % server.server_address[1]
    bodies = [open(f"{folder}/req{i}.png", "rb").read() for i in range(4)]
    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())
    with ThreadPoolExecutor(4) as ex:
        answers = list(ex.map(post, bodies))
    depths = [np.load(io.BytesIO(base64.b64decode(a["npz_base64"])))["depth"] for a in answers]
    np.savez(f"{folder}/served.npz", *depths, f=[a["focallength_px"] for a in answers])
    server.shutdown()
    server.server_close()
    thread.join(30)
print(f"WORKER{rank}_OK", flush=True)
"""


def _serve_requests(folder):
    rng = np.random.default_rng(5)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (40 + 8 * i, 56, 3), dtype=np.uint8)).save(
            folder / f"req{i}.png")


def test_serve_dp_over_two_ranks(checkpoint, tmp_path):
    """``create_server(parallel="dp")`` on 2 ranks: rank 0 answers 4 requests
    posted to it, rank 1 follows every batch until rank 0's server closes;
    the answers equal one rank's server on the same requests."""
    _serve_requests(tmp_path)
    outs = spawn(_SERVE_WORKER, 2, checkpoint, tmp_path, timeout=600)
    assert all(f"WORKER{r}_OK" in o for r, o in enumerate(outs))
    followed = int(re.search(r"FOLLOWED (\d+)", outs[1]).group(1))
    assert 1 <= followed <= 4
    import base64
    import io
    import threading
    import urllib.request

    server = create_server(port=0, runner=_port_runner(checkpoint, batch_size=4,
                                                       decode_pool="thread"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/depth?return=npz"
        with np.load(tmp_path / "served.npz") as served:
            for i in range(4):
                body = (tmp_path / f"req{i}.png").read_bytes()
                with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                            timeout=120) as resp:
                    ans = json.loads(resp.read())
                want = np.load(io.BytesIO(base64.b64decode(ans["npz_base64"])))["depth"]
                np.testing.assert_allclose(served[f"arr_{i}"], want, rtol=SERVE_RTOL, atol=0)
                np.testing.assert_allclose(served["f"][i], ans["focallength_px"],
                                           rtol=SERVE_RTOL)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)


_SERVE_FAULT_WORKER = r"""
import io, threading, time, urllib.error, urllib.request
import numpy as np
from PIL import Image
from ml_depth_pro_video_tpu_torch.serve import server as server_module
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
(http_port,) = args
if rank == 1:
    def broken(self, images):
        raise RuntimeError("injected forward fault")
    DepthVideoRunner.depth_stream = broken
else:
    def client():
        url = f"http://127.0.0.1:{http_port}"
        for _ in range(600):
            try:
                urllib.request.urlopen(url + "/healthz", timeout=5).read()
                break
            except OSError:
                time.sleep(0.1)
        buf = io.BytesIO()
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, format="PNG")
        try:
            urllib.request.urlopen(urllib.request.Request(url + "/v1/depth", data=buf.getvalue()),
                                   timeout=300)
            print("ANSWER 200", flush=True)
        except urllib.error.HTTPError as exc:
            print(f"ANSWER {exc.code}", flush=True)
    threading.Thread(target=client, daemon=True).start()
server_module.main(["--model", "tiny", "--device", "cpu", "--parallel", "dp", "--max_batch", "2",
                    "--host", "127.0.0.1", "--port", http_port,
                    "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(n),
                    "--process_id", str(rank)])
print("SERVED ON", flush=True)
"""


def test_serve_forward_failure_stops_every_rank():
    """A forward that fails on one rank of a 2-rank dp server (here the
    follower's) ends both processes with an error: rank 0 answers the batch's
    client 500 and its ``serve_forever`` raises, instead of serving on with
    the ranks at different collectives."""
    ranks = run(_SERVE_FAULT_WORKER, 2, free_port(), timeout=300, join=False)
    (rc0, out0), (rc1, out1) = ranks
    assert rc1 != 0 and "injected forward fault" in out1, out1
    assert "SERVED ON" not in out1, out1
    assert rc0 != 0 and "ANSWER 500" in out0, out0
    assert "every rank stops" in out0 and "SERVED ON" not in out0, out0


_EXPORT_WORKER = r"""
import dataclasses
import numpy as np
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
ckpt, artifact = args
kw = dict(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=ckpt), precision="fp32",
          batch_size=2, mesh=make_mesh(), decode_workers=1, device="cpu")
served, eager = DepthVideoRunner(exported_path=artifact, **kw), DepthVideoRunner(**kw)
rng = np.random.default_rng(4)
frames = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(3)]
for got, want in zip(served.depth_stream(frames), eager.depth_stream(frames), strict=True):
    assert np.array_equal(got["depth"], want["depth"])
    assert got["focallength_px"] == want["focallength_px"]
assert served.exported_calls == 2 and eager.exported_calls == 0, served.exported_calls
print(f"WORKER{rank}_OK", flush=True)
"""


def test_dp2_artifact_served_by_two_ranks(checkpoint, tmp_path):
    """``depth-pro-export-torch --dp 2``: the per-rank program at batch 1,
    served by a 2-rank dp runner (both batches of 3 frames through it, equal
    to the eager dp runner bit for bit); a one-rank runner refuses it."""
    artifact = str(tmp_path / "dp2.pt2")
    export_main(["-o", artifact, "--tiny", "--device", "cpu", "--batch_size", "2",
                 "--precision", "fp32", "--dp", "2"])
    outs = spawn(_EXPORT_WORKER, 2, checkpoint, artifact, timeout=600)
    assert all(f"WORKER{r}_OK" in o for r, o in enumerate(outs))
    with pytest.raises(ValueError, match="re-export with no --dp"):
        _port_runner(checkpoint, batch_size=2, exported_path=artifact)
