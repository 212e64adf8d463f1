"""Time the attention kernels beside an earlier revision of their sources and SDPA.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``::

    python3 scripts/torch_attention_variants.py [--parent OLD.cu [OLD2.cu ...]] [--fp32]

Builds the shipped attention sources (``csrc/attention_packed.cu``, the
entry points, and ``csrc/attention_wgmma.cu``, the bf16 hd = 64 body of K1,
K3 and K4) into one library with ``-Xptxas -v`` and prints the registers and
spill bytes of every hd = 64 kernel instance, and any ``ptxas`` warning
that it serialised wgmma. ``--parent`` builds an
earlier revision beside it: one source or several (for instance PR 4's
single ``attention_packed.cu``, from ``git show
<commit>:ml_depth_pro_video_tpu_torch/csrc/attention_packed.cu`` written to a
file in a directory that git ignores, such as ``build/``; a source's
``#include "..."`` headers are found beside it), both ``nvcc`` runs started together. Then each build
runs the same bf16 inputs at the model's shapes in turns (three rounds, the
median of the rounds' medians), beside ``scaled_dot_product_attention`` on
the same views (a yardstick the port never calls), with its largest error
against the plain version: K1 and K3 on the packed qkv, K4 on (B, H, S, 64)
q, k, v. Each build's host time per launch (the ctypes call, the device
rule and tensor-map encoding included) is read at K1's (2, 577, 3072) over
calls that the card queues. ``--fp32`` times the fp32 body too.
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
    BODIES,
    _split_packed,
    attention_packed_reference,
    attention_reference,
)

SOURCES = [loader.CSRC_DIR / "attention_packed.cu", loader.CSRC_DIR / "attention_wgmma.cu"]
# (B, S, heads, with a bias): the exact path's two shapes at batch 2, one between, the
# latency, dp and pp shapes of the paths across ranks, the tiers' at batch 2 and the latency
# path's at fast
SHAPES = [(70, 577, 16, False), (2, 577, 16, False), (8, 577, 16, False),
          (18, 577, 16, False), (35, 577, 16, False), (14, 577, 16, False),
          (70, 577, 8, False), (70, 433, 16, True), (70, 289, 16, True), (18, 289, 16, True)]
K4_SHAPES = [(70, 16, 577)]  # (B, H, S): a ViT-L block's attention at batch 2
HOST_SHAPE = (2, 577, 16)  # K1's host time per launch, at the image ViT's shape
HOST_CALLS = 200  # fewer than the launch queue holds, so the host never waits on the card
HD = 64
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_USED = re.compile(r"Used (\d+) registers")
_SERIALIZED = re.compile(r"wgmma.mma_async instructions are serialized")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_INSTANCE = re.compile(r"attention_(bf16|fp32)_kernelILi(\d+)ELb([01])E(?:Li(\d)E)?")
_WGMMA = re.compile(r"attention_wgmma_kernelILi(\d)E(?:Lb([01])E)?")


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
    """An attention kernel instance's name, where it is one of hd = 64 (the
    wgmma body's instances are all of hd = 64, bf16; before it took a bias,
    its one template argument was the warpgroups)."""
    if wg := _WGMMA.search(entry):
        return f"wgmma hd={HD} bias={wg.group(2) or 0} warpgroups={wg.group(1)}"
    inst = _INSTANCE.search(entry)
    if not inst or inst.group(2) != str(HD):
        return None
    kind, hd, bias, mt = inst.groups()
    return f"{kind} hd={hd} bias={bias}" + (f" m-tiles={mt}" if mt else "")


def build_all(sources: dict, tmp: Path, describe=attention_instance) -> dict:
    """Build each source, or list of sources, into its own library, all
    ``nvcc`` runs started together; print the registers and spills of every
    kernel instance that ``describe`` names. Returns {name: CDLL}, its entry
    points not yet typed."""
    procs = {}
    for name, source in sources.items():
        lib = tmp / f"{name}.so"
        srcs = [str(p) for p in (source if isinstance(source, (list, tuple)) else [source])]
        cmd = [loader._nvcc(), *loader.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(lib),
               *srcs]
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
        for line in out.splitlines():
            if _SERIALIZED.search(line):
                print(f"[ptxas]   {line.strip()}")
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


def call_bhsd(lib, q, k, v, out):
    b, h, s, hd = q.shape
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.attention_bhsd_forward(p(q), p(k), p(v), p(out), b, s, h, hd,
                                     int(q.dtype == torch.bfloat16), hd ** -0.5, 0,
                                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"launch returned cudaError {err}")


def body_of(lib, b: int, s: int, heads: int, dtype) -> str:
    """' [<body> body, <n> queries per block]' of this shape in the shipped build."""
    body, rows = ctypes.c_int(), ctypes.c_int()
    lib.attention_kernel_body(b, s, heads, HD, int(dtype == torch.bfloat16), 0,
                              ctypes.byref(body), ctypes.byref(rows))
    return f" [{BODIES[body.value]} body, {rows.value} queries per block]"


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call over ``calls`` calls that the card queues
    (the card's time is not in it: the host never waits)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def rounds_of(fns: dict, iters: int) -> dict:
    """Three rounds of each function's median time, in turns."""
    rounds = {name: [] for name in fns}
    for _ in range(3):
        for name, fn in fns.items():
            rounds[name].append(median_ms(fn, iters))
    return rounds


def print_rounds(tag: str, rounds: dict, errs: dict, bodies: str = "") -> None:
    for name, ts in rounds.items():
        err = f" rel err {errs[name]:.3e}" if name in errs else ""
        body = bodies if name == "shipped" else ""
        print(f"[time] {tag} {name}: {statistics.median(ts):.4f} ms "
              f"(rounds {', '.join(f'{t:.4f}' for t in ts)}){err}{body}", flush=True)


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
    ap.add_argument("--parent", type=Path, nargs="+",
                    help="an earlier revision of the kernel sources (one or more .cu files)")
    ap.add_argument("--fp32", action="store_true", help="time the fp32 body as well")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    disable_tf32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}")
    sources = {"shipped": SOURCES}
    if ns.parent:
        sources["parent"] = ns.parent
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = build_all(sources, Path(tmp))
        for name, lib in libs.items():
            syms = ["attention_packed_forward", "attention_packed_bias_forward",
                    "attention_bhsd_forward"] + (["attention_kernel_body"] if name == "shipped"
                                                 else [])
            for sym in syms:
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = loader._SIGNATURES[sym]
        print(f"[build] {len(libs)} builds in parallel: {time.perf_counter() - t0:.1f} s")
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
                tag = (f"K{3 if with_bias else 1} ({b},{s},{3 * heads * HD})"
                       f"{' + bias' if with_bias else ''} {dtype}")
                print_rounds(tag, rounds_of(fns, 100 if b * s < 8192 else 20), errs,
                             body_of(libs["shipped"], b, s, heads, dtype))
        for b, h, s in K4_SHAPES:
            q, k, v = (torch.randn((b, h, s, HD), generator=g, device="cuda").bfloat16()
                       for _ in range(3))
            out = torch.empty_like(q)
            ref = attention_reference(q, k, v).float()
            fns = {name: (lambda lib=lib: call_bhsd(lib, q, k, v, out))
                   for name, lib in libs.items()}
            fns["library"] = lambda: F.scaled_dot_product_attention(q, k, v)
            errs = {}
            for name, lib in libs.items():
                out.zero_()
                call_bhsd(lib, q, k, v, out)
                torch.cuda.synchronize()
                errs[name] = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            print_rounds(f"K4 ({b},{h},{s},{HD}) torch.bfloat16", rounds_of(fns, 20), errs,
                         body_of(libs["shipped"], b, s, h, torch.bfloat16))
        b, s, heads = HOST_SHAPE
        qkv = torch.randn((b, s, 3 * heads * HD), generator=g, device="cuda").bfloat16()
        out = torch.empty((b, s, heads * HD), dtype=qkv.dtype, device="cuda")
        host = {name: [] for name in libs}
        for _ in range(3):
            for name, lib in libs.items():
                host[name].append(host_us(lambda lib=lib: call(lib, qkv, None, out, heads)))
        for name, us in host.items():
            print(f"[host] K1 ({b},{s},{3 * heads * HD}) {name}: {statistics.median(us):.2f} us "
                  f"per launch on the host (rounds {', '.join(f'{u:.2f}' for u in us)})")
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
