"""How far fp32 takes the Poisson conjugate gradient of ``geom/mesh.py``.

Run from the repository root (the card is optional)::

    python3 scripts/torch_poisson_precision.py [--res 256] [--devices cpu cuda]

It builds the screened Poisson system of ``depth-pro-mesh-torch`` (``voxel``
0.05 m, screening 4, ``_poisson_system``) from a cloud of ``chip_smoke.py``'s
structured 1080x1920 room (its true depth) on a ``res``^3 grid, then runs
``_poisson_cg`` (300 iterations, tol 1e-6) on each device twice: as the port
sums its dot products (products in fp32, the sum in float64, rounded to
fp32), and with fp32 sums (``torch.sum`` of the fp32 products, as the JAX
package sums). A float64 solve on the CPU is the reference. It prints the
iterations of each solve and, for each pair, max |diff| over the reference's
max |chi|.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from ml_depth_pro_video_tpu_torch.geom import mesh  # noqa: E402


def fp32_sum(a, b, prod, wide):
    return torch.sum(torch.mul(a, b, out=prod))


def system(res: int):
    scene = chip_smoke.structured_scene(1080, 1920, chip_smoke.SCENE_F_PX, chip_smoke.SEED + 8)
    cloud = chip_smoke.depth_to_3d(scene["depth"], scene["f_px"], image=scene["image"])
    down = mesh.voxel_downsample(cloud, chip_smoke.POISSON_VOXEL)
    nrm = mesh.estimate_normals(down.points, radius=chip_smoke.POISSON_VOXEL * 2)
    origin, spacing = mesh._grid_frame(down.points, res)
    b, diag, _ = mesh._poisson_system(down.points, nrm, res, origin, spacing,
                                      chip_smoke.POISSON_SCREEN)
    return b, diag


def solve(b, diag, device: str, dtype, sums) -> tuple[np.ndarray, int, float]:
    bt = torch.as_tensor(b, dtype=dtype, device=device)
    d = torch.as_tensor(diag, dtype=dtype, device=device)
    real = mesh._dot
    mesh._dot = sums or real
    try:
        t0 = time.perf_counter()
        x, n = mesh._poisson_cg(bt, d, 300, 1e-6)
        out = x.cpu().numpy().astype(np.float64)
    finally:
        mesh._dot = real
    return out, n, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--devices", nargs="+", default=["cpu", "cuda"])
    args = ap.parse_args(argv)
    devices = [d for d in args.devices if d == "cpu" or torch.cuda.is_available()]
    b, diag = system(args.res)
    runs = {"float64 cpu": solve(b, diag, "cpu", torch.float64, fp32_sum)}
    for dev in devices:
        runs[f"port {dev}"] = solve(b, diag, dev, torch.float32, None)
        runs[f"fp32 sums {dev}"] = solve(b, diag, dev, torch.float32, fp32_sum)
    card = chip_smoke.card() if "cuda" in devices else "no card"
    print(f"[poisson precision] {args.res}^3 screened system of the structured room; "
          f"{torch.get_num_threads()} CPU threads; {card}")
    for name, (_, n, s) in runs.items():
        print(f"[poisson precision] {name}: {n} iterations in {s:.3f} s")
    scale = np.abs(runs["float64 cpu"][0]).max()
    for a, c in itertools.combinations(runs, 2):
        err = np.abs(runs[a][0] - runs[c][0]).max() / scale
        print(f"[poisson precision] {a} against {c}: max |diff| {err:.3e} of max |chi|")
    return 0


if __name__ == "__main__":
    sys.exit(main())
