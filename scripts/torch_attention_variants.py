"""Time the attention kernel beside an earlier revision of its source and SDPA.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``::

    python3 scripts/torch_attention_variants.py [--parent OLD_attention_packed.cu] [--fp32]

Builds ``csrc/attention_packed.cu`` with ``-Xptxas -v`` and prints the
registers and spill bytes of every hd = 64 kernel instance. ``--parent``
builds an earlier revision of the source beside it (for instance
``git show HEAD~1:ml_depth_pro_video_tpu_torch/csrc/attention_packed.cu``
written to a file), both ``nvcc`` runs started together. Then each build
runs the same bf16 inputs at the model's shapes in turns (three rounds, the
median of the rounds' medians), beside ``scaled_dot_product_attention`` on
the same views (a yardstick the port never calls) and with its largest error
against the plain version. ``--fp32`` times the fp32 body too.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ml_depth_pro_video_tpu_torch.core.precision import disable_tf32  # noqa: E402
from ml_depth_pro_video_tpu_torch.kernels import loader  # noqa: E402
from ml_depth_pro_video_tpu_torch.ops.attention import (  # noqa: E402
    _split_packed,
    attention_packed_reference,
)

SOURCE = loader.CSRC_DIR / "attention_packed.cu"
# (B, S, heads, with a bias): the exact path's two shapes at batch 2, one between, the tiers'
SHAPES = [(70, 577, 16, False), (2, 577, 16, False), (8, 577, 16, False),
          (70, 433, 16, True), (70, 289, 16, True)]
HD = 64
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_INSTANCE = re.compile(r"attention_(bf16|fp32)_kernelILi(\d+)ELb([01])E(?:Li(\d)E)?")


def ptxas_rows(log: str) -> list[tuple[str, int, int, int]]:
    """(mangled entry, registers, spill store bytes, spill load bytes) per
    kernel instance from ``nvcc -Xptxas -v`` output."""
    rows, entry, spill = [], None, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
        elif m := _SPILL.search(line):
            spill = m.groups()
        elif (m := _USED.search(line)) and entry:
            rows.append((entry, int(m.group(1)), int(spill[0]), int(spill[1])))
            entry = None
    return rows


def attention_instance(entry: str) -> str | None:
    """An attention kernel instance's name, where it is one of hd = 64."""
    inst = _INSTANCE.search(entry)
    if not inst or inst.group(2) != str(HD):
        return None
    kind, hd, bias, mt = inst.groups()
    return f"{kind} hd={hd} bias={bias}" + (f" m-tiles={mt}" if mt else "")


def build_all(sources: dict, tmp: Path, describe=attention_instance) -> dict:
    """Build each source into its own library, all ``nvcc`` runs started
    together; print the registers and spills of every kernel instance that
    ``describe`` names. Returns {name: CDLL}, its entry points not yet typed."""
    procs = {}
    for name, source in sources.items():
        lib = tmp / f"{name}.so"
        cmd = [loader._nvcc(), *loader.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(lib),
               str(source)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        print(f"[ptxas] {name}:")
        for entry, regs, stores, loads in ptxas_rows(out):
            if (inst := describe(entry)) is not None:
                print(f"[ptxas]   {inst}: {regs} registers, spill stores/loads {stores}/{loads} B")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def call(lib, qkv, bias, out, heads):
    b, s, d3 = qkv.shape
    hd = d3 // 3 // heads
    args = (b, s, heads, hd, int(qkv.dtype == torch.bfloat16), hd ** -0.5, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    if bias is None:
        err = lib.attention_packed_forward(p(qkv), p(out), *args)
    else:
        err = lib.attention_packed_bias_forward(p(qkv), p(bias), p(out), *args)
    if err:
        raise RuntimeError(f"launch returned cudaError {err}")


def median_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an earlier revision of the kernel source")
    ap.add_argument("--fp32", action="store_true", help="time the fp32 body as well")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    disable_tf32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}")
    sources = {"shipped": SOURCE}
    if ns.parent:
        sources["parent"] = ns.parent
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = build_all(sources, Path(tmp))
        for lib in libs.values():
            for sym in ("attention_packed_forward", "attention_packed_bias_forward"):
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = loader._SIGNATURES[sym]
        print(f"[build] {len(libs)} sources in parallel: {time.perf_counter() - t0:.1f} s")
        g = torch.Generator(device="cuda").manual_seed(0)
        for b, s, heads, with_bias in SHAPES:
            base = torch.randn((b, s, 3 * heads * HD), generator=g, device="cuda")
            bias = (torch.randint(1, 5, (b, s), generator=g, device="cuda").float().log()
                    if with_bias else None)
            for dtype in (torch.bfloat16, torch.float32) if ns.fp32 else (torch.bfloat16,):
                qkv = base.to(dtype)
                out = torch.empty((b, s, heads * HD), dtype=dtype, device="cuda")
                ref = attention_packed_reference(qkv, heads, bias).float()
                q, k, v = _split_packed(qkv, heads)
                mask = None if bias is None else bias[:, None, None, :].to(dtype)
                fns = {name: (lambda lib=lib: call(lib, qkv, bias, out, heads))
                       for name, lib in libs.items()}
                fns["library"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                errs = {}
                for name, lib in libs.items():
                    out.zero_()
                    call(lib, qkv, bias, out, heads)
                    torch.cuda.synchronize()
                    errs[name] = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                iters = 100 if b * s < 8192 else 20
                rounds = {name: [] for name in fns}
                for _ in range(3):
                    for name, fn in fns.items():
                        rounds[name].append(median_ms(fn, iters))
                tag = f"({b},{s},{3 * heads * HD}){' + bias' if with_bias else ''} {dtype}"
                for name, ts in rounds.items():
                    err = f" rel err {errs[name]:.3e}" if name in errs else ""
                    print(f"[time] {tag} {name}: {statistics.median(ts):.4f} ms "
                          f"(rounds {', '.join(f'{t:.4f}' for t in ts)}){err}", flush=True)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
