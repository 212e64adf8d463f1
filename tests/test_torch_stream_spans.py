"""The host spans of ``DepthVideoRunner.depth_stream``, on the CPU.

A tiny fp32 runner streams 7 frames at batch 2 (three full batches and a
tail of one) under ``torch.profiler`` (CPU activity), and the exported
Chrome trace is read back: the five spans of ``video/runner.py`` appear,
one stage, launch and collect per batch, numbered 0..3, flat on the
stream's thread and covering its loop, and the answers equal an unprofiled
stream's bit for bit. With no profiler running, ``span`` opens no
``record_function``. ``scripts/torch_stream_spans.py``'s split of the
card's idle time by span is checked on a hand-built trace.
"""

import importlib.util
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh
from ml_depth_pro_video_tpu_torch.utils import profiling
from ml_depth_pro_video_tpu_torch.video import runner as runner_mod
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_stream_spans.py"
_spec = importlib.util.spec_from_file_location("torch_stream_spans", _PATH)
spans_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(spans_script)

PHASES = ("wait_frames", "stage", "launch", "collect", "caller")
FRAMES, BATCH = 7, 2
BATCHES = 4  # three full batches and a tail of one


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _frames(n=FRAMES, h=60, w=84, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _runner(**kw):
    return DepthVideoRunner(cfg=tiny_config(), precision="fp32", batch_size=BATCH,
                            decode_workers=1, device="cpu", **kw)


def _profiled(stream_of, path):
    """Consume ``stream_of()`` under the profiler; (answers, trace dict)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = list(stream_of())
    prof.export_chrome_trace(str(path))
    return got, json.loads(path.read_text())


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(unprofiled answers, profiled answers, the stream's spans, the trace)."""
    runner = _runner()
    frames = _frames()
    plain = list(runner.depth_stream(frames))
    got, trace = _profiled(lambda: runner.depth_stream(frames),
                           tmp_path_factory.mktemp("spans") / "trace.json")
    return plain, got, spans_script.stream_spans(trace), trace


def _assert_tiled(spans):
    """One thread, and each span starts at or after the one before ends."""
    assert len({s[4] for s in spans}) == 1
    for before, after in zip(spans, spans[1:]):
        assert after[2] >= before[3], (before, after)


@pytest.mark.parametrize("phase", PHASES)
def test_each_span_appears(traced, phase):
    _, _, spans, _ = traced
    counts = Counter(s[1] for s in spans if s[0] == phase)
    assert counts, phase
    if phase in ("stage", "launch", "collect", "caller"):
        # one per batch: the stage, launch, collect and caller spans of batch N join
        assert counts == {b: 1 for b in range(BATCHES)}


def test_batch_numbers_run_from_zero(traced):
    _, _, spans, _ = traced
    assert [s[1] for s in spans if s[0] == "stage"] == list(range(BATCHES))
    assert [s[1] for s in spans if s[0] == "collect"] == list(range(BATCHES))
    # the loader's queue is waited on for the batch being filled
    assert {s[1] for s in spans if s[0] == "wait_frames"} <= set(range(BATCHES))
    assert {s[0] for s in spans} == set(PHASES)


def test_stream_thread_spans_never_overlap(traced):
    _, _, spans, _ = traced
    _assert_tiled(spans)


def test_spans_cover_the_stream_thread(traced):
    _, _, spans, _ = traced
    first = next(s for s in spans if s[0] == "wait_frames")
    last = [s for s in spans if s[0] == "caller"][-1]
    covered = sum(s[3] - s[2] for s in spans if s[2] >= first[2] and s[3] <= last[3])
    assert covered >= 0.95 * (last[3] - first[2])


def test_spans_are_annotations_not_ops(traced):
    """The benchmark's slice names idle gaps by ``cpu_op`` events and ties
    kernels to ``depth_pro::`` ones: the spans are neither."""
    _, _, _, trace = traced
    named = [e for e in trace["traceEvents"] if e.get("name", "").startswith("depth_stream.")]
    assert named and {e.get("cat") for e in named} == {"user_annotation"}


def test_profiled_answers_equal_unprofiled_ones(traced):
    plain, got, _, _ = traced
    assert len(got) == len(plain) == FRAMES
    for g, p in zip(got, plain):
        assert np.array_equal(g["depth"], p["depth"])
        assert g["focallength_px"] == p["focallength_px"]


def test_no_record_function_without_a_profiler(traced, monkeypatch):
    plain, _, _, _ = traced

    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got = list(_runner().depth_stream(_frames()))
    assert len(got) == FRAMES
    for g, p in zip(got, plain):
        assert np.array_equal(g["depth"], p["depth"])
        assert g["focallength_px"] == p["focallength_px"]


def test_span_is_a_flag_read_off_and_a_named_range_on(tmp_path):
    assert profiling.span("depth_stream.stage", 3) is profiling.span("x")  # one null context
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("depth_stream.stage", 3), profiling.span("plain"):
            torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = {e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert names == {"depth_stream.stage#3", "plain"}


@pytest.mark.parametrize("mesh", [False, True], ids=["one_device", "dp_mesh_of_one_rank"])
def test_spans_tile_with_a_retry_and_on_a_dp_mesh(mesh, tmp_path, monkeypatch):
    """A device error retried inside ``_run`` and the dp program (which
    stages this rank's rows inside ``_forward``) keep the spans flat and
    numbered; the retried batch is staged and launched again."""
    runner = _runner(max_retries=1, **({"mesh": make_mesh()} if mesh else {}))
    monkeypatch.setattr(runner_mod.time, "sleep", lambda s: None)
    real_infer, calls = runner._infer, []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real_infer(*args)

    monkeypatch.setattr(runner, "_infer", flaky)
    got, trace = _profiled(lambda: runner.depth_stream(_frames(5)), tmp_path / "t.json")
    spans = spans_script.stream_spans(trace)
    assert len(got) == 5 and len(calls) == 4
    _assert_tiled(spans)
    assert [s[1] for s in spans if s[0] == "collect"] == [0, 1, 2]
    assert Counter(s[1] for s in spans if s[0] == "launch") == {0: 1, 1: 1, 2: 1}


def test_no_span_outside_depth_stream(tmp_path):
    """``_forward`` opens spans only inside a stream: the pod stream and
    other callers get none."""
    runner = _runner()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner._forward(np.stack(_frames(2)), None, False)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    assert spans_script.stream_spans(json.loads((tmp_path / "t.json").read_text())) == []


# --- scripts/torch_stream_spans.py on a hand-built trace (µs) ------------------------

def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _hand_trace(annotations=True):
    upload = "Memcpy HtoD (Pinned -> Device)"
    events = [
        _x("gpu_memcpy", upload, 100, 10, tid=7, bytes=800),   # batch 0's upload opens the window
        _x("kernel", "k_a", 110, 40, tid=7, correlation=1),
        _x("gpu_memset", "Memset (Device)", 150, 10, tid=7, correlation=5),
        _x("kernel", "k_b", 200, 60, tid=7, correlation=2),
        _x("gpu_memcpy", upload, 300, 10, tid=7, bytes=800),
        _x("kernel", "k_c", 310, 90, tid=7, correlation=3),
        _x("kernel", "k_d", 450, 30, tid=7, correlation=4),
        _x("gpu_memcpy", upload, 500, 10, tid=7, bytes=800),   # two batches later: the end
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 505, 10, tid=7, bytes=64),
        _x("cuda_runtime", "cudaLaunchKernel", 95, 2, correlation=1),
        _x("cuda_runtime", "cudaMemsetAsync", 140, 2, correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", 180, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 185, 2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 440, 2, correlation=4),
        _x("cpu_op", "aten::add", 176, 10),
    ]
    if annotations:
        events += [
            _x("user_annotation", "depth_stream.wait_frames#0", 90, 30),
            _x("user_annotation", "depth_stream.stage#0", 120, 50),
            _x("user_annotation", "depth_stream.launch#0", 170, 100),
            _x("user_annotation", "depth_stream.collect#0", 270, 20),
            _x("user_annotation", "depth_stream.caller#0", 290, 130),
            _x("user_annotation", "depth_stream.wait_frames#1", 420, 10),
            _x("user_annotation", "depth_stream.stage#1", 430, 40),
            _x("user_annotation", "depth_stream.launch#1", 470, 50),
            _x("user_annotation", "some_other_range", 150, 300),
            # the device track's copy of a host range: not the stream's thread
            _x("gpu_user_annotation", "depth_stream.launch#0", 175, 225, tid=7),
        ]
    return {"traceEvents": events}


# busy in [100, 500): [100, 160) [200, 260) [300, 400) [450, 480) = 250 of 400 µs;
# idle [160, 200) [260, 300) [400, 450) [480, 500) = 150 µs, by the spans over them:
# stage#0 10, launch#0 30 + 10, collect#0 20, caller#0 10 + 20, wait_frames#1 10,
# stage#1 20, launch#1 20 (to the window's end)
HAND = {"wait_frames": 10, "stage": 30, "launch": 60, "collect": 20, "caller": 30}


@pytest.mark.parametrize("phase", PHASES)
def test_idle_split_by_span_on_a_hand_built_trace(phase):
    trace = _hand_trace()
    lo, hi = spans_script.window(trace, marker_bytes=800, batches=2)
    assert (lo, hi) == (100, 500)
    split = spans_script.idle_split(trace, lo, hi)
    assert split["idle"] == pytest.approx(100 * 150 / 400)
    assert split[phase] == pytest.approx(100 * HAND[phase] / 400)
    assert sum(split[p] for p in PHASES) == pytest.approx(split["idle"])


def test_idle_split_without_spans_reads_nothing():
    split = spans_script.idle_split(_hand_trace(annotations=False), 100, 500)
    assert split["idle"] == pytest.approx(37.5)
    assert all(split[p] is None for p in PHASES)


def test_enqueue_order_flags_an_event_before_its_span():
    trace = _hand_trace()

    def counts(order):
        return {p: (row["events"], row["early"], row["before_call"]) for p, row in order.items()}

    # k_a from wait_frames#0, the memset from stage#0 and k_d from stage#1, k_b and k_c
    # from launch#0: none before its span or its own launch call
    assert counts(spans_script.enqueue_order(trace)) == {
        "wait_frames": (1, 0, 0), "stage": (2, 0, 0), "launch": (2, 0, 0), "collect": (0, 0, 0),
        "caller": (0, 0, 0)}
    # a kernel stamped 5 µs before launch#0 opened, launched inside it 35 µs later
    trace["traceEvents"].append(_x("kernel", "k_e", 165, 3, tid=7, correlation=9))
    trace["traceEvents"].append(_x("cuda_runtime", "cudaLaunchKernel", 200, 2, correlation=9))
    launch = spans_script.enqueue_order(trace)["launch"]
    assert (launch["events"], launch["early"], launch["before_call"]) == (3, 1, 1)
    assert launch["most_early_us"] == 5
