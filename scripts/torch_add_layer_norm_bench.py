"""Time K5 (``ops/norm.py::add_layer_norm``, ``csrc/add_layer_norm.cu``)
beside its bytes bound and the plain composition.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``::

    python3 scripts/torch_add_layer_norm_bench.py [--rounds 5] [--calls 50]

Prints what ``ptxas`` reports for every instance of the kernel (registers,
spills), then, at the video cells' patch-ViT residual streams (280 x 577 and
280 x 289 rows of 1024, bf16), for each of K5's three modes: K5's time and
the plain composition's (``add_layer_norm_reference``: the casts, the fp32
LayerNorm, ``torch.addcmul``) in turns (plain, K5, K5, plain per round; each
reading CUDA events around ``--calls`` back-to-back calls, whose kernels
keep the card busy; the median over the rounds), and K5's share of its
bound: the bytes it must move (x and branch read, x_new and y written, the
fp32 parameters read once) over 3.35 TB/s, the H100 SXM's HBM3 peak at 700 W.
Then the host's microseconds per call in add and LayerNorm mode at the
image ViT's stream of an 8-frame batch (8 x 577 rows) and at 64 rows, where
the card waits on the host: wall clock over ``--host-calls`` back-to-back
calls, between synchronisations, of the operator, of its CUDA wrapper alone
(no dispatcher), of the bare launch (``Kernel.launch`` on arguments made
once: ctypes, the entry point, the CUDA launch) and of the plain composition.
The card's name and power limit come first; the last line is JSON, also
written to ``build/add_layer_norm_bench.json`` (ignored by git).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ml_depth_pro_video_tpu_torch.kernels import loader  # noqa: E402
from ml_depth_pro_video_tpu_torch.ops import norm as N  # noqa: E402

PEAK_BYTES = 3.35e12
SHAPES = [(280 * 577, 1024), (280 * 289, 1024)]
MODES = {"add_norm": (True, True), "norm": (False, True), "add": (True, False)}
EPS = 1e-6


def ptxas_report() -> list[str]:
    """``ptxas -v``'s lines for the kernel's instances."""
    src = loader.CSRC_DIR / "add_layer_norm.cu"
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([loader._nvcc(), *loader.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "k5.o"), str(src)],
                             capture_output=True, text=True, check=True)
    return [ln.strip() for ln in out.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def bytes_moved(rows: int, d: int, mode: str) -> int:
    add, norm = MODES[mode]
    per_element = 2 * (1 + add) + 2 * (add + norm)  # bf16 reads, then writes
    return rows * d * per_element + 4 * d * (add + 2 * norm)


def time_ms(fn, calls: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--host-calls", type=int, default=3000)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    for line in ptxas_report():
        print(f"ptxas: {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out = []
    for rows, d in SHAPES:
        for mode, (add, norm) in MODES.items():
            x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
            branch = (torch.randn((rows, d), generator=gen, device="cuda").bfloat16() if add
                      else None)
            ls = torch.rand(d, generator=gen, device="cuda") if add else None
            g = torch.randn(d, generator=gen, device="cuda") if norm else None
            b = torch.randn(d, generator=gen, device="cuda") if norm else None
            ins = (x, branch, ls, g, b, EPS)

            def kernel():
                N.add_layer_norm_op(*ins)

            def plain():
                N.add_layer_norm_reference(*ins)

            for fn in (plain, kernel):  # warm-up: the build, the allocator's blocks
                fn()
            times = {"plain": [], "k5": []}
            for _ in range(args.rounds):
                for name, fn in (("plain", plain), ("k5", kernel), ("k5", kernel),
                                 ("plain", plain)):
                    times[name].append(time_ms(fn, args.calls))
            k5, ref = statistics.median(times["k5"]), statistics.median(times["plain"])
            bound = 1e3 * bytes_moved(rows, d, mode) / PEAK_BYTES
            entry = {"rows": rows, "d": d, "mode": mode, "k5_ms": round(k5, 5),
                     "plain_ms": round(ref, 5), "bound_ms": round(bound, 5),
                     "k5_share_of_bound": round(100 * bound / k5, 2),
                     "speedup": round(ref / k5, 3),
                     "k5_rounds": [round(t, 5) for t in times["k5"]]}
            rows_out.append(entry)
            print(f"({rows}, {d}) {mode}: K5 {k5:.4f} ms ({100 * bound / k5:.1f}% of the bytes "
                  f"bound {bound:.4f} ms), plain {ref:.4f} ms ({ref / k5:.2f}x)", flush=True)
            del x, branch
            torch.cuda.empty_cache()
    host = []
    for rows in (8 * 577, 64):
        d = 1024
        ins = (torch.randn((rows, d), generator=gen, device="cuda").bfloat16(),
               torch.randn((rows, d), generator=gen, device="cuda").bfloat16(),
               *(torch.rand(d, generator=gen, device="cuda") for _ in range(3)), EPS)
        outs = [torch.empty_like(ins[0]) for _ in range(2)]
        bare = [ctypes.c_void_p(t.data_ptr()) for t in (*ins[:5], *outs)] + [
            rows, d, EPS, 0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
        fns = {"operator": lambda: N.add_layer_norm_op(*ins),
               "wrapper": lambda: N._add_layer_norm_cuda(*ins),
               "launch": lambda: N.K5.launch(*bare),
               "plain": lambda: N.add_layer_norm_reference(*ins)}
        with torch.inference_mode():
            for fn in fns.values():
                host_us(fn, 100)
            us = {name: [host_us(fn, args.host_calls) for _ in range(args.rounds)]
                  for name, fn in fns.items()}
        entry = {"rows": rows, "d": d, **{f"{k}_us": round(statistics.median(v), 2)
                                          for k, v in us.items()}}
        host.append(entry)
        print(f"host, ({rows}, {d}) add_norm: " + ", ".join(
            f"{k} {statistics.median(v):.2f} us" for k, v in us.items()), flush=True)
    result = {"card": card, "torch": torch.__version__, "shapes": rows_out, "host": host}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "add_layer_norm_bench.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
