"""The port's HTTP depth server (``serve/server.py``) on the CPU.

Every case of ``tests/test_serve.py`` runs against the port's server on a
tiny fp32 CPU runner; then the same PNG (and the same session stream) goes to
the JAX server and to the port's, both on one npz of weights, and depth and
focal length must agree within the JAX package's parity bar, rtol 1e-3 /
atol 1e-4. The batcher's failure paths run on stub runners.
"""

import base64
import concurrent.futures
import dataclasses
import http.client
import io
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.serve import server as jserver
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.ckpt.export import main as export_main
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.serve import server
from ml_depth_pro_video_tpu_torch.serve.server import _Batcher, _Sessions, create_server
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from ml_depth_pro_video_tpu_torch.video.temporal import TemporalSmoother
from torch_checkpoint import write_tiny_checkpoint

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def port_server(checkpoint):
    runner = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                              precision="fp32", batch_size=2, decode_workers=1, device="cpu")
    srv = create_server(port=0, runner=runner, max_batch=2, max_wait_ms=20)
    yield srv, _serve(srv)
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def server_url(port_server):
    return port_server[1]


@pytest.fixture(scope="module")
def jax_url(checkpoint):
    runner = JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint),
                       precision="fp32", batch_size=2, decode_workers=1)
    srv = jserver.create_server(port=0, runner=runner, max_batch=2, max_wait_ms=20)
    yield _serve(srv)
    srv.shutdown()
    srv.server_close()


def _png(shape=(80, 100, 3), seed=0):
    img = (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, query="", timeout=120):
    req = urllib.request.Request(url + "/v1/depth" + query, data=body,
                                 headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers, r.read()


def _post_npz(url, body, query=""):
    _, raw = _post(url, body, "?return=npz" + query)
    payload = json.loads(raw)
    with np.load(io.BytesIO(base64.b64decode(payload["npz_base64"]))) as z:
        return z["depth"], payload


def _metrics(url) -> tuple[dict, str]:
    with urllib.request.urlopen(url + "/metrics") as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    values = {}
    for line in text.splitlines():
        if line.startswith("#") or "{" in line:
            continue
        name, val = line.rsplit(" ", 1)
        values[name] = float(val)
    return values, text


def test_healthz(server_url):
    with urllib.request.urlopen(server_url + "/healthz") as r:
        body = json.load(r)
    assert body == {"status": "ok", "device": "cpu"}


def test_depth_json_and_npz(server_url):
    depth, body = _post_npz(server_url, _png())
    assert body["depth_shape"] == [80, 100]
    assert depth.shape == (80, 100) and np.isfinite(depth).all()
    assert body["depth_min"] == float(depth.min()) and body["depth_max"] == float(depth.max())
    _, raw = _post(server_url, _png(), "?return=json")
    assert "npz_base64" not in json.loads(raw)


def test_depth_png16(server_url):
    headers, raw = _post(server_url, _png(seed=1), "?return=png16")
    img = Image.open(io.BytesIO(raw))
    assert img.size == (100, 80) and np.asarray(img).dtype == np.uint16
    _, body = _post_npz(server_url, _png(seed=1))
    assert float(headers["X-Depth-Min"]) == pytest.approx(body["depth_min"], abs=1e-6)
    assert float(headers["X-Depth-Max"]) == pytest.approx(body["depth_max"], abs=1e-6)
    assert float(headers["X-Focallength-Px"]) == pytest.approx(body["focallength_px"], abs=1e-3)
    assert "X-Smooth-Seeded" not in headers


def test_concurrent_requests_batched(server_url):
    before, _ = _metrics(server_url)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        res = list(pool.map(lambda i: json.loads(_post(server_url, _png(seed=i))[1]), range(4)))
    assert all(r["depth_shape"] == [80, 100] for r in res)
    after, _ = _metrics(server_url)
    assert after["depthpro_batch_frames_total"] - before["depthpro_batch_frames_total"] == 4
    assert after["depthpro_batches_total"] - before["depthpro_batches_total"] <= 4


def test_bad_route_and_bad_payload(server_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server_url + "/nope")
    assert e.value.code == 404
    req = urllib.request.Request(server_url + "/v2/depth", data=_png(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, b"not an image")
    assert e.value.code == 500


@pytest.mark.parametrize("length,code", [(0, 411), (server.MAX_BODY + 1, 413)])
def test_length_required_and_body_too_large(server_url, length, code):
    conn = http.client.HTTPConnection(server_url.split("//")[1], timeout=30)
    try:
        conn.putrequest("POST", "/v1/depth")
        conn.putheader("Content-Length", str(length))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == code and "error" in json.loads(resp.read())
    finally:
        conn.close()


def test_concurrent_mixed_resolution_requests(server_url):
    """Requests of different sizes are never stacked into one batch."""
    bodies = [_png((80, 100, 3), 1), _png((64, 48, 3), 2)]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        res = list(pool.map(lambda b: json.loads(_post(server_url, b)[1]), bodies))
    assert res[0]["depth_shape"] == [80, 100]
    assert res[1]["depth_shape"] == [64, 48]


def test_metrics_endpoint(server_url):
    _post(server_url, _png(seed=7))
    metrics, text = _metrics(server_url)
    assert metrics["depthpro_requests_total"] >= 1
    assert metrics["depthpro_batches_total"] >= 1
    assert metrics["depthpro_batch_frames_total"] >= metrics["depthpro_batches_total"]
    assert 0 < metrics["depthpro_batch_fill_ratio"] <= 1
    assert metrics["depthpro_request_latency_seconds_count"] == metrics[
        "depthpro_requests_total"]
    assert metrics["depthpro_request_latency_seconds_sum"] > 0
    counts = [float(l.rsplit(" ", 1)[1]) for l in text.splitlines()
              if l.startswith("depthpro_request_latency_seconds_bucket")]
    assert counts == sorted(counts) and len(counts) == len(server._LATENCY_BUCKETS) + 1
    assert counts[-1] == metrics["depthpro_requests_total"]
    # the JAX server's metric names, letter for letter
    names = {l.split()[2] for l in jserver._Metrics().render(2).splitlines()
             if l.startswith("# TYPE")}
    assert names == {l.split()[2] for l in server._Metrics().render(2).splitlines()
                     if l.startswith("# TYPE")}
    assert server._LATENCY_BUCKETS == jserver._LATENCY_BUCKETS


def test_temporal_smooth_runner_rejected():
    runner = DepthVideoRunner(cfg=tiny_config(), precision="fp32", batch_size=2,
                              temporal_smooth=0.8, device="cpu")
    with pytest.raises(ValueError, match="temporal_smooth"):
        _Batcher(runner, max_batch=2, max_wait_ms=20)


def _video_frames(n, seed=20, shape=(48, 64, 3)):
    """A jittery static scene: base frame + small per-frame noise."""
    rng = np.random.default_rng(seed)
    base = (rng.random(shape) * 255).astype(np.uint8)
    out = []
    for _ in range(n):
        f = np.clip(base.astype(np.int16) + rng.integers(-3, 4, shape), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="PNG")
        out.append(buf.getvalue())
    return out


def test_session_smoothing_matches_offline_filter(server_url):
    """?session=&smooth= equals TemporalSmoother over the sessionless
    responses frame for frame; two interleaved sessions each track their own
    stream."""
    frames_a, frames_b = _video_frames(4, seed=40), _video_frames(4, seed=50)
    raw_a = [_post_npz(server_url, f)[0] for f in frames_a]
    raw_b = [_post_npz(server_url, f)[0] for f in frames_b]
    got_a, got_b = [], []
    for fa, fb in zip(frames_a, frames_b):  # interleaved streams
        got_a.append(_post_npz(server_url, fa, "&session=a&smooth=0.8")[0])
        got_b.append(_post_npz(server_url, fb, "&session=b&smooth=0.8")[0])
    for raw, got in ((raw_a, got_a), (raw_b, got_b)):
        ref = TemporalSmoother(alpha=0.8, host=True)
        for r, g in zip(raw, got):
            np.testing.assert_array_equal(g, ref.update(r))  # the same host filter
    assert not np.allclose(got_a[2], raw_a[2])  # later frames were smoothed
    _, text = _metrics(server_url)
    assert "depthpro_smooth_sessions 2" in text


@pytest.mark.parametrize("query", ["&smooth=0.8", "&session=x", "&session=x&smooth=1.0",
                                   "&session=x&smooth=nope", "&session=x&smooth=0.8&tau=abc",
                                   "&session=x&smooth=0.8&tau=-1", "&session=x&smooth=0.8&tau=0",
                                   "&session=x&smooth=0.8&tau=nan"])
def test_session_smoothing_param_validation(server_url, query):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_npz(server_url, _video_frames(1)[0], query)
    assert e.value.code == 400


def test_sessions_ttl_and_lru_eviction():
    d = np.full((4, 4), 2.0, np.float32)
    s = _Sessions(ttl_s=1e-9, max_sessions=8)
    s.apply("a", 0.8, 0.05, d)
    s.apply("b", 0.8, 0.05, d)  # purge drops the now-idle "a"
    with s._lock:
        assert set(s._entries) == {"b"}
    assert s.eviction_counts()["ttl"] >= 1

    s = _Sessions(ttl_s=3600.0, max_sessions=2)
    for name in ("a", "b", "c"):
        s.apply(name, 0.8, 0.05, d)
    assert s.count() == 2  # "a" (LRU) evicted
    assert s.eviction_counts() == {"ttl": 0, "lru": 1}

    out, seeded = s.apply("fresh", 0.8, 0.05, d * 3)
    np.testing.assert_allclose(out, d * 3)
    assert seeded is True
    _, seeded = s.apply("fresh", 0.8, 0.05, d * 3)
    assert seeded is False
    _, seeded = s.apply("fresh", 0.5, 0.05, d * 3)  # a new alpha re-seeds
    assert seeded is True

    s = _Sessions(ttl_s=1e-9, max_sessions=8)  # count() purges on an idle server
    s.apply("idle", 0.8, 0.05, d)
    time.sleep(0.01)
    assert s.count() == 0

    s = _Sessions(ttl_s=0.05, max_sessions=8)  # an expired entry never resurrects
    out, seeded = s.apply("stale", 0.8, 0.05, d)
    assert seeded is True
    time.sleep(0.08)
    out, seeded = s.apply("stale", 0.8, 0.05, d * 2)
    assert seeded is True
    np.testing.assert_allclose(out, d * 2)
    assert s.eviction_counts()["ttl"] >= 1


def test_session_eviction_visible_over_http(server_url):
    frames = _video_frames(3, seed=40)

    def post(body, query):
        return json.loads(_post(server_url, body, "?return=json" + query)[1])

    assert "smooth_seeded" not in post(frames[0], "")
    assert post(frames[0], "&session=ev&smooth=0.8")["smooth_seeded"] is True
    assert post(frames[1], "&session=ev&smooth=0.8")["smooth_seeded"] is False
    headers, _ = _post(server_url, frames[2], "?return=png16&session=ev&smooth=0.8")
    assert headers["X-Smooth-Seeded"] == "0"
    _, text = _metrics(server_url)
    assert 'depthpro_smooth_evictions_total{reason="lru"}' in text
    assert 'depthpro_smooth_evictions_total{reason="ttl"}' in text


def test_port_server_matches_jax_server(server_url, jax_url):
    """One PNG through both servers (host resize to 512^2 and back included)."""
    for shape, seed in (((80, 100, 3), 3), ((512, 512, 3), 4)):
        body = _png(shape, seed)
        got, gp = _post_npz(server_url, body)
        want, wp = _post_npz(jax_url, body)
        assert got.shape == want.shape == shape[:2]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gp["focallength_px"], wp["focallength_px"], rtol=RTOL,
                                   atol=ATOL)


def test_port_session_stream_matches_jax_server(server_url, jax_url):
    for i, frame in enumerate(_video_frames(4, seed=60)):
        got, gp = _post_npz(server_url, frame, "&session=p&smooth=0.8")
        want, wp = _post_npz(jax_url, frame, "&session=p&smooth=0.8")
        assert gp["smooth_seeded"] is wp["smooth_seeded"] is (i == 0)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


class _StubRunner:
    """A runner stand-in: ``depth_stream`` is ``fn(images)``; records batches."""

    def __init__(self, fn, size=4):
        self.cfg = types.SimpleNamespace(img_size=size)
        self.batch_size = 1
        self.device = torch.device("cpu")
        self.fn = fn
        self.batches = []

    def depth_stream(self, images):
        self.batches.append([im.shape for im in images])
        return self.fn(images)


def _ok(images):
    return [{"depth": np.ones(im.shape[:2], np.float32), "focallength_px": 1.0}
            for im in images]


@pytest.mark.parametrize("fn,message", [
    (lambda images: _ok(images)[:1], "frame dropped"),
    (lambda images: (_ for _ in ()).throw(ValueError("boom")), "boom"),
])
def test_batcher_fails_every_waiting_client(fn, message):
    runner = _StubRunner(fn)
    batcher = _Batcher(runner, max_batch=2, max_wait_ms=200, canonical=False)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(batcher.infer, np.zeros((4, 4, 3), np.uint8)) for _ in range(2)]
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(f.result(timeout=30))
                except RuntimeError as exc:
                    outcomes.append(str(exc))
        assert runner.batches == [[(4, 4, 3)] * 2]
        assert any(message in str(o) for o in outcomes)
        if message == "boom":
            assert all("boom" in o for o in outcomes)
        assert batcher.metrics.errors == sum(isinstance(o, str) for o in outcomes) >= 1
    finally:
        batcher.close()


def test_batcher_routes_each_result_to_its_client_under_contention():
    """48 clients (more than the cores) with a tiny switch interval: each gets
    its own frame's depth back, and the counters add up."""
    import sys

    def echo(images):
        return [{"depth": np.full(im.shape[:2], float(im[0, 0, 0]), np.float32),
                 "focallength_px": float(im[0, 0, 0])} for im in images]

    runner = _StubRunner(echo)
    batcher = _Batcher(runner, max_batch=4, max_wait_ms=5, canonical=False)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(48) as pool:
            futs = {i: pool.submit(batcher.infer, np.full((4, 4, 3), i, np.uint8))
                    for i in range(48)}
            got = {i: f.result(timeout=60) for i, f in futs.items()}
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
    assert all(g["focallength_px"] == i and (g["depth"] == i).all() for i, g in got.items())
    m = batcher.metrics
    assert m.requests == m.frames == 48 and m.errors == 0
    assert m.batches == len(runner.batches) >= 12
    assert all(len(b) <= 4 for b in runner.batches)


def test_batcher_times_out_and_holds_an_odd_shape_over():
    release = threading.Event()
    runner = _StubRunner(lambda images: (release.wait(30), _ok(images))[1])
    batcher = _Batcher(runner, max_batch=3, max_wait_ms=300, canonical=False, timeout_s=0.2)
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            shapes = [(4, 4, 3), (6, 4, 3), (4, 4, 3)]
            futs = []
            for s in shapes:
                futs.append(pool.submit(batcher.infer, np.zeros(s, np.uint8)))
                time.sleep(0.02)
            for f in futs:
                with pytest.raises(RuntimeError, match="timed out"):
                    f.result(timeout=30)
            release.set()
        deadline = time.monotonic() + 30
        while len(runner.batches) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        # the (6, 4) request broke the first batch and headed the next
        assert runner.batches[0] == [(4, 4, 3)]
        assert runner.batches[1][0] == (6, 4, 3)
    finally:
        release.set()
        batcher.close()
    assert not batcher._thread.is_alive()


def test_warmup_runs_one_canonical_full_batch():
    runner = _StubRunner(_ok, size=8)
    runner.batch_size = 3
    srv = create_server(port=0, runner=runner, max_batch=2, warmup_shape=(80, 100))
    try:
        assert runner.batches == [[(8, 8, 3)] * 3]  # max_batch rose to the runner's batch
        assert srv.batcher.max_batch == 3 and srv.batcher.runner is runner
    finally:
        srv.server_close()
    assert not srv.batcher._thread.is_alive()


def test_unported_modes_raise(monkeypatch):
    """The multi-device modes, which raised before they were ported: one rank
    runs ``--parallel dp`` and ``latency`` unsharded (a rank drives one card
    whatever the count, so two visible cards change nothing); several ranks
    refuse ``--parallel none`` (``tests/test_torch_multihost.py`` serves over
    2 ranks); an unknown mode raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for parallel in ("dp", "latency"):
        made = create_server(port=0, model="tiny", parallel=parallel, device="cpu",
                             max_batch=1)
        try:
            assert made.batcher.runner.mesh is None
        finally:
            made.server_close()
    monkeypatch.setattr(server.multihost, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="over 2 ranks pass --parallel dp or latency"):
        create_server(port=0, model="tiny", parallel="none", device="cpu")
    with pytest.raises(ValueError, match="parallel"):
        create_server(port=0, model="tiny", parallel="tp", device="cpu")


def test_create_server_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for parallel in ("none", "dp"):
        with pytest.raises(RuntimeError, match="CUDA"):
            create_server(port=0, model="tiny", parallel=parallel)


def test_cli_serves_one_request(monkeypatch, capsys):
    """``depth-pro-serve-torch --device cpu --model tiny --port 0`` answers a
    request; ``shutdown`` ends ``main``, which closes the server."""
    made = []
    real = server.create_server

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(server, "create_server", recording)
    thread = threading.Thread(target=server.main, args=(
        ["--device", "cpu", "--model", "tiny", "--host", "127.0.0.1", "--port", "0",
         "--max_batch", "1", "--parallel", "dp"],), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not made and time.monotonic() < deadline:
        time.sleep(0.05)
    srv = made[0]
    assert srv.batcher.runner.precision.compute_dtype == torch.bfloat16
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    depth, body = _post_npz(url, _png((40, 56, 3), 9))
    assert body["depth_shape"] == [40, 56] and np.isfinite(depth).all() and (depth > 0).all()
    srv.shutdown()
    thread.join(30)
    assert not thread.is_alive() and not srv.batcher._thread.is_alive()
    assert f"serving on 127.0.0.1:{srv.server_address[1]} (cpu)" in capsys.readouterr().out


def test_cli_serves_through_an_artifact(monkeypatch, tmp_path):
    """``depth-pro-serve-torch --exported`` (tiny, bf16 as the server builds
    its runner, ``--max_batch 1`` = the artifact's batch) answers a request
    through the artifact, equal to an eager server's answer bit for bit."""
    art = str(tmp_path / "tiny.pt2")
    export_main(["-o", art, "--tiny", "--device", "cpu", "--batch_size", "1"])
    made = []
    real = server.create_server

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(server, "create_server", recording)
    thread = threading.Thread(target=server.main, args=(
        ["--device", "cpu", "--model", "tiny", "--host", "127.0.0.1", "--port", "0",
         "--max_batch", "1", "--exported", art],), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not made and time.monotonic() < deadline:
        time.sleep(0.05)
    srv = made[0]
    eager = real(port=0, model="tiny", max_batch=1, device="cpu")
    try:
        body = _png((40, 56, 3), 10)
        got, _ = _post_npz(f"http://127.0.0.1:{srv.server_address[1]}", body)
        want, _ = _post_npz(_serve(eager), body)
        assert srv.batcher.runner.exported_calls == 1
        assert eager.batcher.runner.exported_calls == 0
        assert np.array_equal(got, want)
    finally:
        eager.shutdown()
        eager.server_close()
        srv.shutdown()
        thread.join(30)
    assert not thread.is_alive() and not srv.batcher._thread.is_alive()
