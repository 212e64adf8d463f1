"""The program's host spans leave every reading of a traced slice as it was.

``DepthVideoRunner.depth_stream`` marks its loop with ``depth_stream.*``
ranges while a profiler runs: ``user_annotation`` events on the host thread,
which the profiler mirrors as ``gpu_user_annotation`` ranges on the device
track. On a hand-built Chrome trace, ``trace.read`` gives the same slice with
and without them, and so every per-layer metric of ``BENCHMARK.json`` and the
``breakdown`` of a ``--trace 1`` line read the same.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest

from portbench import run, trace
from portbench.reference.depth_pro import Arch

ROOT = run.ROOT
UPLOAD = "Memcpy HtoD (Pinned -> Device)"
MARKER = 8 * 1080 * 1920 * 3


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _trace() -> dict:
    """Two batches of a stream: uploads, an attention operator's kernel, a
    K2 call, GEMMs, glue and a conv, host ops around idle stretches."""
    ev = []
    corr = iter(range(1, 100))

    def kernel(name, ts, dur, launch_ts, tid=1):
        c = next(corr)
        ev.append(_x("kernel", name, ts, dur, tid=7, correlation=c))
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch_ts, 3, tid=tid, correlation=c))

    for b, t0 in enumerate((1000, 3000)):
        ev.append(_x("gpu_memcpy", UPLOAD, t0, 40, tid=7, bytes=MARKER))
        ev.append(_x("cpu_op", "aten::to", t0 - 60, 50))
        ev.append(_x("cpu_op", "depth_pro::attention_packed", t0 + 100, 30,
                     **{"Input Dims": [[16, 577, 3072]]}))
        kernel("void depth_pro_attention::attention_wgmma_kernel<2, false>", t0 + 150, 200,
               t0 + 110)
        ev.append(_x("cpu_op", "aten::addmm", t0 + 140, 20))
        kernel("nvjet_tst_256x144_64x4_1x2_h_bz_coopA_bias_NNT", t0 + 400, 300, t0 + 145)
        kernel("vectorized_layer_norm_kernel", t0 + 720, 80, t0 + 170)
        ev.append(_x("cpu_op", "depth_pro::resblock", t0 + 180, 20,
                     **{"Input Dims": [[2, 96, 96, 256], [3, 3, 256, 256]]}))
        kernel("resblock_wgmma_kernel", t0 + 850, 120, t0 + 185)
        kernel("sm90_xmma_fprop_implicit_gemm_bf16bf16", t0 + 1300, 250, t0 + 200)
        kernel("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>",
               t0 + 1560, 30, t0 + 210)
        ev.append(_x("gpu_memset", "Memset (Device)", t0 + 1600, 5, tid=7))
        ev.append(_x("cpu_op", "aten::unbind", t0 + 1000, 200))
    ev.append(_x("gpu_memcpy", UPLOAD, 5000, 40, tid=7, bytes=MARKER))
    return {"traceEvents": ev}


def _annotated(raw: dict) -> dict:
    """The same trace with the stream's spans on the host thread, their
    device-track mirrors, and a range of another name."""
    out = copy.deepcopy(raw)
    phases = ["wait_frames", "stage", "launch", "collect", "caller"]
    for b, t0 in enumerate((900, 2900)):
        for i, phase in enumerate(phases):
            s = t0 + 400 * i
            out["traceEvents"].append(_x("user_annotation", f"depth_stream.{phase}#{b}", s, 400))
            out["traceEvents"].append(_x("gpu_user_annotation", f"depth_stream.{phase}#{b}",
                                         s + 250, 400, tid=7))
    out["traceEvents"].append(_x("user_annotation", "ProfilerStep#1", 800, 4500))
    return out


def _readings(raw: dict):
    sl = trace.read(raw, marker_bytes=MARKER, frames_per_batch=8, max_batches=6)
    assert sl is not None and sl.batches == 2 and sl.busy_s > 0
    man = run.manifest(ROOT)
    mctx = run.MetricContext(sl, Arch())
    values = {}
    for m in man["per_layer"]:
        reader = run.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
        values[m["name"]] = reader.read(mctx)
    return sl, values, {"device_ops": sl.top_ops(10), "idle_gaps": sl.top_gaps(10)}


def test_the_hand_built_slice_reads_every_metric():
    _, values, breakdown = _readings(_trace())
    assert all(v is not None for k, v in values.items() if not k.startswith(
        ("merge_", "k3_"))), values
    assert breakdown["idle_gaps"] and breakdown["device_ops"]


@pytest.mark.parametrize("part", ["slice", "metrics", "breakdown"])
def test_spans_leave_the_readings_as_they_were(part):
    plain, annotated = _readings(_trace()), _readings(_annotated(_trace()))
    index = {"slice": 0, "metrics": 1, "breakdown": 2}[part]
    if part == "slice":
        assert dataclasses.asdict(annotated[0]) == dataclasses.asdict(plain[0])
    else:
        assert annotated[index] == plain[index]
