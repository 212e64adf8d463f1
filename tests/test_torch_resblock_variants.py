"""The ``ptxas`` parsing and the C-entry reading of
``scripts/torch_resblock_variants.py`` (and of the attention script's
``ptxas_rows``, which it imports), on synthetic ``nvcc -Xptxas -v`` output."""

import importlib.util
import sys
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_resblock_variants.py"
_spec = importlib.util.spec_from_file_location("torch_resblock_variants", _PATH)
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)
attention = sys.modules["torch_attention_variants"]

_ENTRY = "_ZN12_GLOBAL__N_115resblock_kernelILi{}ELi{}EEEvPK13__nv_bfloat16S3_PKfS3_S5_PS1_iii"
_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_ENTRY.format(8, 8)}' for 'sm_90a'
ptxas info    : Function properties for {_ENTRY.format(8, 8)}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '{_ENTRY.format(6, 6)}' for 'sm_90a'
ptxas info    : Function properties for {_ENTRY.format(6, 6)}
    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115resblock_kernelEPK13__nv_bfloat16S3_PKfS3_S5_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115resblock_kernelEPK13__nv_bfloat16S3_PKfS3_S5_PS1_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_ptxas_rows_pair_each_entry_with_its_registers_and_spills():
    rows = attention.ptxas_rows(_LOG)
    assert [(regs, stores, loads) for _, regs, stores, loads in rows] == [
        (168, 0, 0), (255, 16, 24), (128, 0, 0)]
    assert [variants.resblock_instance(entry) for entry, *_ in rows] == [
        "resblock_kernel tile 8x8", "resblock_kernel tile 6x6", "resblock_kernel"]


@pytest.mark.parametrize("entry,name", [
    ("_ZN12_GLOBAL__N_121attention_bf16_kernelILi64ELb1ELi2EEEvNS_4ArgsI13__nv_bfloat16EE",
     "bf16 hd=64 bias=1 m-tiles=2"),
    ("_ZN12_GLOBAL__N_121attention_fp32_kernelILi64ELb0EEEvNS_4ArgsIfEE", "fp32 hd=64 bias=0"),
    ("_ZN12_GLOBAL__N_121attention_bf16_kernelILi32ELb0ELi1EEEvNS_4ArgsI13__nv_bfloat16EE", None),
    ("_ZN12_GLOBAL__N_115resblock_kernelILi8ELi8EEEvPK13__nv_bfloat16", None),
])
def test_attention_instances_are_the_head_dim_64_ones(entry, name):
    assert attention.attention_instance(entry) == name


def test_entry_arity_tells_the_padded_width_entry_apart(tmp_path):
    first = tmp_path / "first.cu"
    first.write_text('extern "C" int resblock_forward(const void* x, const void* w1, const void* '
                     'b1,\n const void* w2, const void* b2, void* out, int B, int H, int W, '
                     'int C, int cp,\n int device, void* stream) {')
    assert variants.entry_arity(first) == 13
    assert variants.entry_arity(variants.SOURCE) == 12
