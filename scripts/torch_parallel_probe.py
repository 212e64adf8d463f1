"""Time inference across ranks (``parallel/``): the dp runner's frames/s and
the latency mode's ms per frame over N ranks, beside one rank alone.

    python3 scripts/torch_parallel_probe.py [--ranks N] [--frames 16]

One process per rank, started by this script on a free local port. N
defaults to the visible cards: with a card per rank the tensor collectives
run on nccl; with fewer cards than ranks the ranks share them over gloo
(the rule of ``parallel/multihost.py::choose_backend``). Rank 0 first times
one rank alone (the runner without a mesh at batch 1 and 2) while the others
wait; then all ranks time the dp runner at 1 and 2 frames per rank and,
in turns, two latency designs at batch 1: the row bands with their halo
exchanges (``parallel/latency.py``) and the decoder and head whole on every
rank after the token gathers. For each they count the gathers and exchanges
of one forward (synchronised around each) and hold its depth against the
unsharded runner's. ``large`` preset, bf16, random weights from seed 0, frames of
1080x1920 in memory. ``--device cpu --model tiny`` runs it on the CPU.
Prints each reading with the card's name and power limit, then one JSON
line of all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ml_depth_pro_video_tpu_torch.models.depth_pro import model_preset  # noqa: E402
from ml_depth_pro_video_tpu_torch.parallel import latency as latency_module  # noqa: E402
from ml_depth_pro_video_tpu_torch.parallel import multihost as mh  # noqa: E402
from ml_depth_pro_video_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner  # noqa: E402

ROUNDS = 3  # the two latency designs timed in turns


def card(device: str) -> str:
    if device != "cuda":
        return "the CPU (not a device reading)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(sorted(set(out.stdout.strip().splitlines())))


def timed_stream(runner: DepthVideoRunner, frames: list, device: str) -> float:
    """Seconds of one stream over ``frames`` after a warm-up batch."""
    list(runner.depth_stream(frames[:runner.batch_size]))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in runner.depth_stream(frames))
    if device == "cuda":
        torch.cuda.synchronize()
    assert n == len(frames)
    return time.perf_counter() - t0


def worker(rank: int, n: int, port: str, args) -> None:
    if args.device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mh.initialize(f"127.0.0.1:{port}", n, rank, device=args.device)
    cfg = model_preset(args.model)
    kw = dict(cfg=cfg, precision="bf16", rng_seed=0, decode_pool="thread", device=args.device)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, tuple(args.shape) + (3,), dtype=np.uint8)
              for _ in range(args.frames)]
    res = {"ranks": n, "backend": mh.cluster().backend, "reason": mh.cluster().reason}
    ref = None
    if rank == 0:  # one rank alone, the others waiting
        for b in (1, 2):
            plain = DepthVideoRunner(batch_size=b, **kw)
            secs = timed_stream(plain, frames, args.device)
            res[f"one rank batch {b} frames/s"] = len(frames) / secs
            if b == 1:
                res["one rank ms per frame"] = 1000 * secs / len(frames)
                ref = [r["depth"] for r in plain.depth_stream(frames[:2])]
            del plain
    mh.barrier()
    for per_rank in (1, 2):
        dp = DepthVideoRunner(batch_size=per_rank * n, mesh=make_mesh(), **kw)
        res[f"dp {per_rank} per rank frames/s"] = len(frames) / timed_stream(dp, frames,
                                                                            args.device)
        del dp
    lat = DepthVideoRunner(batch_size=1, mesh=make_mesh(), parallel="latency", **kw)
    # the alternative to the row bands: the decoder and head whole on every rank after the
    # token gathers (no halos), built with the bands switched off
    real_bands = latency_module.RowBands
    latency_module.RowBands = lambda grid, mesh: None
    try:
        whole = DepthVideoRunner(batch_size=1, mesh=make_mesh(), parallel="latency", **kw)
    finally:
        latency_module.RowBands = real_bands
    times = {"latency": [], "latency decoder whole": []}
    for _ in range(ROUNDS):  # in turns
        for name, runner in (("latency", lat), ("latency decoder whole", whole)):
            times[name].append(1000 * timed_stream(runner, frames, args.device) / len(frames))
    for name, ms in times.items():
        res[f"{name} ms per frame"] = statistics.median(ms)
        res[f"{name} ms per frame, each round"] = ms
    counts = {}
    real = {"all_gather": mh.all_gather, "exchange": mh.exchange}

    def counted(name):
        def fn(*a):
            if args.device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a)
            if args.device == "cuda":
                torch.cuda.synchronize()
            counts[name][0] += 1
            counts[name][1] += time.perf_counter() - t0
            return out
        return fn

    for tag, runner in (("latency", lat), ("latency decoder whole", whole)):
        counts.update({name: [0, 0.0] for name in real})
        for name in real:
            setattr(mh, name, counted(name))
        try:
            got = [r["depth"] for r in runner.depth_stream(frames[:2])]
        finally:
            for name, fn in real.items():
                setattr(mh, name, fn)
        for name, (calls, secs) in counts.items():
            res[f"{tag} {name} calls per forward"] = calls / 2
            res[f"{tag} {name} ms per forward"] = 500 * secs
        if rank == 0:
            inv, inv_ref = 1.0 / np.stack(got), 1.0 / np.stack(ref)
            share = np.abs(inv - inv_ref) / np.abs(inv_ref).max()
            res[f"{tag} against one rank p99"] = float(np.quantile(share, 0.99))
            res[f"{tag} against one rank max"] = float(share.max())
    if rank == 0:
        if args.device == "cuda":
            res["peak bytes rank 0"] = torch.cuda.max_memory_allocated()
        print("RESULT " + json.dumps(res), flush=True)
    mh.barrier()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (default: the visible cards, or 2 on the CPU)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--shape", type=int, nargs=2, default=(1080, 1920), metavar=("H", "W"))
    ap.add_argument("--model", default="large")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        worker(args.rank, args.ranks, args.port, args)
        return 0
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_parallel_probe: no CUDA device")
        from ml_depth_pro_video_tpu_torch.kernels.loader import load_library

        load_library()  # one build; the ranks load it
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    rest = list(argv if argv is not None else sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *rest,
                                   "--ranks", str(n), "--rank", str(r), "--port", port],
                                  stdout=log, stderr=subprocess.STDOUT, text=True)
                 for r, log in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=1800)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read())
                log.close()
    if any(p.returncode for p in procs):
        for r, (p, out) in enumerate(zip(procs, outs)):
            print(f"rank {r} exited {p.returncode}:\n" + "\n".join(out.splitlines()[-30:]))
        return 1
    res = json.loads(next(line[7:] for line in outs[0].splitlines()
                          if line.startswith("RESULT ")))
    where = card(args.device)
    print(f"{n} ranks, tensor collectives on {res['backend']} ({res['reason']}); "
          f"{args.model}, bf16, {args.frames} frames of {args.shape[0]}x{args.shape[1]}, on {where}")
    for k, v in res.items():
        if k not in ("ranks", "backend", "reason"):
            print(f"  {k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
