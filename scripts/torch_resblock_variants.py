"""Time the fused residual block (K2) beside an earlier revision of its source
and the plain composition.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``::

    python3 scripts/torch_resblock_variants.py [--parent OLD_resblock.cu]

Builds ``csrc/resblock.cu`` with ``-Xptxas -v`` and prints the registers and
spill bytes of every kernel instance. ``--parent`` builds an earlier
revision of the source beside it (for instance
``git show <commit>:ml_depth_pro_video_tpu_torch/csrc/resblock.cu`` written
to a file; a source whose C entry still takes the padded width, as the
first one did, is called with it); both ``nvcc`` runs start together.
Then each build and the plain composition (two cuDNN convolutions, two
ReLUs, the adds: ``residual_block_reference``) run the same bf16 inputs at
the decoder's four widths at batch 2 in turns (three rounds, the median of
the rounds' medians, each a median over runs of back-to-back calls, as
``chip_smoke.py`` times), each with its device time from the profiler (the
plain composition's launches leave the card waiting on the host) and each
build with its largest error against the plain version (share of its scale).
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_attention_variants import build_all  # noqa: E402

from chip_smoke import device_ms, median_ms  # noqa: E402
from ml_depth_pro_video_tpu_torch.core.precision import disable_tf32  # noqa: E402
from ml_depth_pro_video_tpu_torch.kernels import loader  # noqa: E402
from ml_depth_pro_video_tpu_torch.ops.resblock import residual_block_reference  # noqa: E402

SOURCE = loader.CSRC_DIR / "resblock.cu"
# the decoder's residual blocks at batch 2: 48^2 and 96^2 run K2 today, 192^2 and 384^2 the
# plain composition (the width gate)
SHAPES = [(2, 48, 48, 256), (2, 96, 96, 256), (2, 192, 192, 256), (2, 384, 384, 256)]
_INSTANCE = re.compile(r"resblock_kernel(?:ILi(\d+)ELi(\d+)E)?")
_ENTRY_ARGS = re.compile(r'extern "C" int resblock_forward\(([^)]*)\)')


def resblock_instance(entry: str) -> str | None:
    """A K2 kernel instance's name: its output tile, where it is a template."""
    m = _INSTANCE.search(entry)
    if not m:
        return None
    return f"resblock_kernel tile {m.group(1)}x{m.group(2)}" if m.group(1) else "resblock_kernel"


def entry_arity(source: Path) -> int:
    """The number of arguments of the source's ``resblock_forward``."""
    m = _ENTRY_ARGS.search(source.read_text())
    if not m:
        raise SystemExit(f"{source}: no resblock_forward entry")
    return m.group(1).count(",") + 1


class Build:
    """One built revision of the source and how to call it: the first source's
    entry takes the padded width after C (13 arguments), later ones do not (12)."""

    def __init__(self, lib: ctypes.CDLL, arity: int):
        if arity not in (12, 13):
            raise SystemExit(f"resblock_forward with {arity} arguments is not known")
        self.fn = lib.resblock_forward
        p, i = ctypes.c_void_p, ctypes.c_int
        self.fn.argtypes = (p,) * 6 + (i,) * (arity - 7) + (p,)
        self.fn.restype = i
        self.padded = arity == 13

    def __call__(self, x, w1, b1, w2, b2, out):
        bsz, h, w, c = x.shape
        ints = (bsz, h, w, c) + ((c,) if self.padded else ()) + (x.device.index,)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, w1, b1, w2, b2, out)]
        err = self.fn(*ptrs, *ints, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"launch returned cudaError {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an earlier revision of the kernel source")
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
        libs = build_all(sources, Path(tmp), describe=resblock_instance)
        print(f"[build] {len(libs)} sources in parallel: {time.perf_counter() - t0:.1f} s")
        builds = {name: Build(lib, entry_arity(sources[name])) for name, lib in libs.items()}
        g = torch.Generator(device="cuda").manual_seed(0)
        for shape in SHAPES:
            c = shape[-1]
            x = (torch.randn(shape, generator=g, device="cuda") * 0.5).bfloat16()
            w1, w2 = (torch.randn((3, 3, c, c), generator=g, device="cuda") * (9 * c) ** -0.5
                      for _ in range(2))
            b1, b2 = (torch.randn((c,), generator=g, device="cuda") * 0.1 for _ in range(2))
            # the kernels' operands: (9, C, C) bf16 weights, biases rounded to bf16 (C % 16 == 0,
            # so the padded width of the first source is C)
            kw1, kw2 = (w.bfloat16().reshape(9, c, c).contiguous() for w in (w1, w2))
            kb1, kb2 = (b.bfloat16().float() for b in (b1, b2))
            out = torch.empty_like(x)
            ref = residual_block_reference(x, w1, b1, w2, b2).float()
            fns = {name: (lambda fn=fn: fn(x, kw1, kb1, kw2, kb2, out))
                   for name, fn in builds.items()}
            fns["plain"] = lambda: residual_block_reference(x, w1, b1, w2, b2)
            errs = {}
            for name, fn in builds.items():
                out.zero_()
                fn(x, kw1, kb1, kw2, kb2, out)
                torch.cuda.synchronize()
                errs[name] = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            rounds = {name: [] for name in fns}
            for _ in range(3):
                for name, fn in fns.items():
                    rounds[name].append(median_ms(fn))
            tag = "x".join(map(str, shape))
            for name, ts in rounds.items():
                err = f" rel err {errs[name]:.3e}" if name in errs else ""
                print(f"[time] ({tag}) bf16 {name}: {statistics.median(ts):.4f} ms "
                      f"(rounds {', '.join(f'{t:.4f}' for t in ts)}); device "
                      f"{device_ms(fns[name]):.4f} ms{err}", flush=True)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
