"""The trace arithmetic of scripts/torch_slice_profile.py, on a synthetic trace."""

import importlib.util
import json
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_slice_profile.py"
_spec = importlib.util.spec_from_file_location("torch_slice_profile", _PATH)
prof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(prof)


@pytest.mark.parametrize("intervals,lo,hi,busy", [
    ([(0, 10), (5, 15), (20, 30)], 0, 40, 25),      # overlap counted once
    ([(0, 10), (5, 15), (20, 30)], 8, 25, 12),      # clipped at both ends
    ([(0, 10), (2, 4)], 0, 10, 10),                  # nested
    ([], 0, 10, 0),
])
def test_busy_in_is_the_clipped_union(intervals, lo, hi, busy):
    assert prof.busy_in(intervals, lo, hi) == busy


@pytest.mark.parametrize("name,group", [
    ("attention_bf16_kernel", "K1 attention (csrc/attention_packed.cu)"),
    ("void (anonymous namespace)::attention_bf16_kernel<64, false>((anonymous namespace)::Args)",
     "K1 attention (csrc/attention_packed.cu)"),
    ("void (anonymous namespace)::attention_bf16_kernel<64, true>((anonymous namespace)::Args)",
     "K3 biased attention (csrc/attention_packed.cu)"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<float>",
     "sort / scatter / gather (ToMe merge and others)"),
    ("resblock_kernel", "K2 resblock (csrc/resblock.cu)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "conv (cuDNN)"),
    ("nvjet_tst_256x136_64x4_2x1_v_bz_coopA_bias_NNT", "GEMM (cuBLAS)"),
    ("Memcpy HtoD (Pinned -> Device)", "copy / cast"),
    ("something_new", "other"),
])
def test_kernel_groups(name, group):
    assert prof.group_of(name) == group


def test_breakdown_drops_first_and_last_batch(tmp_path):
    # 4 batches over 0..400 us: the window is 100..300; two kernels inside it
    # (one straddling its start), one copy, and host events that do not count
    events = [
        {"ph": "X", "cat": "kernel", "name": "attention_bf16_kernel", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "attention_bf16_kernel", "ts": 80, "dur": 60},
        {"ph": "X", "cat": "kernel", "name": "resblock_kernel", "ts": 150, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 200, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "resblock_kernel", "ts": 350, "dur": 50},
    ]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    rep = prof.breakdown(trace, n_batches=4)
    assert rep["window_ms"] == pytest.approx(0.2)
    assert rep["busy_ms"] == pytest.approx(0.14)   # 100..140 and 150..250
    assert rep["idle_share"] == pytest.approx(0.3)
    assert rep["summed_ms"] == pytest.approx(0.16)  # 40 + 100 + 20 us
    assert dict(rep["by_name"]) == pytest.approx(
        {"attention_bf16_kernel": 40.0, "resblock_kernel": 100.0, "Memcpy DtoH": 20.0})


def test_speed_option_takes_the_presets_only(capsys):
    with pytest.raises(SystemExit):
        prof.main(["--speed", "fastest"])
    assert "invalid choice" in capsys.readouterr().err
