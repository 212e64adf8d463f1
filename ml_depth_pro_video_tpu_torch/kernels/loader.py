"""Build and bind the port's hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` file of this package
(one ``nvcc`` per source, all started together) and links the objects into
one shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds, not minutes).
The library lands in ``build/torch_kernels/<hash>/`` under the repository
root (an installed copy, outside a checkout, uses
``ml_depth_pro_video_tpu_torch/torch_kernels/<hash>/`` under
``$XDG_CACHE_HOME``, by default ``~/.cache``),
keyed by a hash of the sources and the flags, so an edited kernel
is rebuilt and an unchanged one is reused. A failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"


def _build_root() -> Path:
    """``build/torch_kernels`` of the checkout (git-ignored) when the package
    runs from one; for an installed copy, a per-user cache directory."""
    checkout = PACKAGE_DIR.parent
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "ml_depth_pro_video_tpu_torch" / "torch_kernels"


BUILD_ROOT = _build_root()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIBRARY_NAME = "libdepth_pro_kernels.so"

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_pi = ctypes.POINTER(ctypes.c_int)
# C signatures of the exported entry points (pointers and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints)
_ATTN_ARGS = (_i, _i, _i, _i, _i, _f, _i, _p)  # B, S, H, hd, is_bf16, scale, device, stream
_SIGNATURES = {
    "attention_packed_forward": ((_p, _p) + _ATTN_ARGS, _i),
    "attention_packed_bias_forward": ((_p, _p, _p) + _ATTN_ARGS, _i),
    "attention_bhsd_forward": ((_p, _p, _p, _p) + _ATTN_ARGS, _i),
    "resblock_forward": ((_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p), _i),  # B, H, W, C, device
    "resblock_tile": ((_i, _i, _i, _i, _pi, _pi), _i),  # B, H, W, device -> rows, columns
}

# names of the cudaError_t codes a launch can plausibly return
_CUDA_ERRORS = {1: "cudaErrorInvalidValue", 2: "cudaErrorMemoryAllocation",
                9: "cudaErrorInvalidConfiguration", 98: "cudaErrorInvalidDeviceFunction",
                100: "cudaErrorNoDevice", 101: "cudaErrorInvalidDevice",
                209: "cudaErrorNoKernelImageForDevice", 700: "cudaErrorIllegalAddress",
                701: "cudaErrorLaunchOutOfResources"}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error (deterministic: not retried)."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built from source at first use")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIBRARY_NAME


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; wait for every one; raise if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise KernelBuildError("\n".join(failed))


def _build(lib_path: Path) -> None:
    nvcc = _nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp_dir:
        objs = [os.path.join(tmp_dir, f"{src.stem}.o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for obj, src in zip(objs, sources())])
        tmp = os.path.join(tmp_dir, LIBRARY_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@dataclasses.dataclass
class Kernel:
    """One hand-written CUDA kernel of the port and its launch count.

    ``launches`` goes up by one exactly where the kernel is launched, so a
    run can show that its main path went through the kernel."""

    name: str
    symbol: str     # exported C entry point
    source: str     # path in the repository
    replaces: str   # the Pallas kernel it ports (file:line)
    launches: int = 0

    def launch(self, *args) -> None:
        err = getattr(load_library(), self.symbol)(*args)
        if err != 0:
            raise KernelLaunchError(
                f"{self.name}: launch returned {_CUDA_ERRORS.get(err, 'cudaError')} ({err})")
        self.launches += 1
