"""The ``ptxas`` parsing of ``scripts/torch_attention_variants.py`` on
synthetic ``nvcc -Xptxas -v`` output of the shipped attention sources: the
wgmma body's instances (``csrc/attention_wgmma.cu``) beside the mma.sync
and fp32 ones (``csrc/attention_packed.cu``), and the source set it builds."""

import importlib.util
import sys
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_attention_variants.py"
variants = sys.modules.get("torch_attention_variants")
if variants is None:
    _spec = importlib.util.spec_from_file_location("torch_attention_variants", _PATH)
    variants = importlib.util.module_from_spec(_spec)
    sys.modules["torch_attention_variants"] = variants
    _spec.loader.exec_module(variants)

_WGMMA = ("_ZN19depth_pro_attention12_GLOBAL__N_122attention_wgmma_kernelILi{}ELb{}EEEv14"
          "CUtensorMap_stS2_S2_S2_NS0_6WgArgsE")
# the wgmma body before it took a bias: one template argument, three maps
_WGMMA_NO_BIAS = ("_ZN19depth_pro_attention12_GLOBAL__N_122attention_wgmma_kernelILi{}EEEv14"
                  "CUtensorMap_stS2_S2_NS0_6WgArgsE")
_BF16 = "_ZN12_GLOBAL__N_121attention_bf16_kernelILi{}ELb1EEEvNS_4ArgsI13__nv_bfloat16EE"
_FP32 = "_ZN12_GLOBAL__N_121attention_fp32_kernelILi{}ELb0EEEvNS_4ArgsIfEE"


def _entry(name: str, regs: int, stores: int, loads: int) -> str:
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, 1024 bytes cmem[0]\n")


# two sources in one nvcc run: the entry points' file (the mma.sync body at hd 32, the fp32
# body), then the wgmma body's four instances
_LOG = ("ptxas info    : 0 bytes gmem\n" + _entry(_BF16.format(32), 128, 0, 0)
        + _entry(_FP32.format(64), 168, 0, 0) + _entry(_FP32.format(32), 96, 0, 0)
        + "ptxas info    : 0 bytes gmem\n" + _entry(_WGMMA.format(2, 0), 95, 0, 0)
        + _entry(_WGMMA.format(1, 0), 122, 0, 0) + _entry(_WGMMA.format(2, 1), 96, 8, 8)
        + _entry(_WGMMA.format(1, 1), 122, 0, 0))


def test_ptxas_rows_read_both_sources_in_order():
    rows = variants.ptxas_rows(_LOG)
    assert [(regs, stores, loads) for _, regs, stores, loads in rows] == [
        (128, 0, 0), (168, 0, 0), (96, 0, 0), (95, 0, 0), (122, 0, 0), (96, 8, 8), (122, 0, 0)]
    assert [variants.attention_instance(entry) for entry, *_ in rows] == [
        None, "fp32 hd=64 bias=0", None, "wgmma hd=64 bias=0 warpgroups=2",
        "wgmma hd=64 bias=0 warpgroups=1", "wgmma hd=64 bias=1 warpgroups=2",
        "wgmma hd=64 bias=1 warpgroups=1"]


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("bias", [0, 1])
def test_wgmma_instances_are_named_by_their_warpgroups(c, bias):
    assert (variants.attention_instance(_WGMMA.format(c, bias))
            == f"wgmma hd=64 bias={bias} warpgroups={c}")


@pytest.mark.parametrize("c", [1, 2])
def test_an_earlier_wgmma_body_s_instances_are_named_too(c):
    """A parent build from before the bias (one template argument) reads as bias=0."""
    assert (variants.attention_instance(_WGMMA_NO_BIAS.format(c))
            == f"wgmma hd=64 bias=0 warpgroups={c}")


def test_serialised_wgmma_warnings_are_found():
    line = ("ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
            "serialized due to insufficient register resources for the function 'f'")
    assert variants._SERIALIZED.search(line) and not variants._SERIALIZED.search(_LOG)


def test_shipped_build_is_both_attention_sources():
    """The shipped build compiles the entry points and the wgmma body into one
    library; the header they share sits beside them."""
    assert [p.name for p in variants.SOURCES] == ["attention_packed.cu", "attention_wgmma.cu"]
    assert all(p.is_file() for p in variants.SOURCES)
    assert (variants.SOURCES[0].parent / "attention.cuh").is_file()
    assert "#include \"attention.cuh\"" in variants.SOURCES[1].read_text()


def test_k4_and_every_k1_model_shape_are_timed():
    assert (70, 16, 577) in variants.K4_SHAPES
    k1 = {(b, s, h) for b, s, h, bias in variants.SHAPES if not bias}
    assert {(70, 577, 16), (2, 577, 16), (18, 577, 16), (35, 577, 16), (14, 577, 16),
            (70, 577, 8)} <= k1


def test_the_tiers_k3_shapes_are_timed():
    """K3 at balanced and fast at batch 2 and at the latency path's fast slice."""
    k3 = {(b, s, h) for b, s, h, bias in variants.SHAPES if bias}
    assert k3 == {(70, 433, 16), (70, 289, 16), (18, 289, 16)}
