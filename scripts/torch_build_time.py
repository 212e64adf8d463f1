"""Time the port's kernel build both ways on one machine.

Run from the repository root on a machine with ``nvcc``::

    python3 scripts/torch_build_time.py

It builds ``ml_depth_pro_video_tpu_torch/csrc/*.cu`` into temporary
directories eight times, alternating the two ways (parallel, serial, serial,
parallel, twice over), so that both see the same machine:

- parallel: ``kernels/loader.py::_build``, one ``nvcc -c`` per source, all
  started together, then one link;
- serial: one ``nvcc -shared`` over every source, which compiles them one
  after the other.

It prints each build's seconds on the host clock and each way's median.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ml_depth_pro_video_tpu_torch.kernels import loader  # noqa: E402

ORDER = ("parallel", "serial", "serial", "parallel") * 2


def build_serial(lib_path: Path) -> None:
    loader._run_all([[loader._nvcc(), *loader.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                      *map(str, loader.sources())]])


BUILDS = {"parallel": loader._build, "serial": build_serial}


def time_builds(order=ORDER) -> dict[str, list[float]]:
    times: dict[str, list[float]] = {way: [] for way in BUILDS}
    with tempfile.TemporaryDirectory() as tmp:
        for i, way in enumerate(order):
            lib = Path(tmp) / str(i) / loader.LIBRARY_NAME
            lib.parent.mkdir()
            t0 = time.perf_counter()
            BUILDS[way](lib)
            times[way].append(time.perf_counter() - t0)
            print(f"[build] {way}: {times[way][-1]} s", flush=True)
    return times


def main() -> int:
    version = subprocess.run([loader._nvcc(), "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc {version}; {os.cpu_count()} CPUs; sources "
          f"{', '.join(p.name for p in loader.sources())}", flush=True)
    for way, ts in time_builds().items():
        print(f"[build] {way}: median {statistics.median(ts)} s of {len(ts)} builds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
