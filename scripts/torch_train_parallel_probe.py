"""Time the training step across ranks (``train/step.py`` with ``dp``, ``tp``,
``pp``): s/step and samples/s of each mode beside one rank alone at the same
global batch, the collectives' calls and ms per step, the peak memory per rank.

    python3 scripts/torch_train_parallel_probe.py [--ranks N] [--batch 4] [--steps 3]
        [--modes dp=4 dp=2,tp=2 dp=2,pp=2 pp=4] [--microbatches 5]

One process per rank, started by this script on a free local port. N
defaults to the visible cards: with a card per rank the tensor collectives
run on nccl; with fewer cards than ranks the ranks share them over gloo
(``parallel/multihost.py::choose_backend``). Rank 0 first times one rank
alone (the one-device step on the whole global batch) while the others
wait; then every rank times each mode: a warm-up step, ``--steps`` steps
(host clock, each ending in a synchronise), then one more step with every
collective synchronised on both sides and timed (calls and ms per step,
rank 0's). ``large`` preset, bf16 on fp32 masters, 1536^2, random weights
and a random batch from seed 0. ``--device cpu --model tiny`` runs it on the
CPU. Prints each reading with the card's name and power limit, then one JSON
line of all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ml_depth_pro_video_tpu_torch.core.precision import Precision  # noqa: E402
from ml_depth_pro_video_tpu_torch.models.depth_pro import build_params, model_preset  # noqa: E402
from ml_depth_pro_video_tpu_torch.parallel import multihost as mh  # noqa: E402
from ml_depth_pro_video_tpu_torch.parallel.mesh import batch_sharding  # noqa: E402
from ml_depth_pro_video_tpu_torch.train import step as step_module  # noqa: E402

COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "transfer")


def card(device: str) -> str:
    if device != "cuda":
        return "the CPU (not a device reading)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(sorted(set(out.stdout.strip().splitlines())))


def parse_mode(text: str) -> dict:
    """``dp=2,tp=2`` -> {"dp": 2, "tp": 2}."""
    return {k: int(v) for k, v in (part.split("=") for part in text.split(","))}


def worker(rank: int, n: int, port: str, args) -> None:
    cuda = args.device == "cuda"
    if not cuda:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mh.initialize(f"127.0.0.1:{port}", n, rank, device=args.device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = model_preset(args.model)
    bf16 = Precision.bf16()
    params = build_params(cfg, args.device, 0)
    rng = np.random.default_rng(0)
    s = cfg.img_size
    images = torch.from_numpy(rng.uniform(-1, 1, (args.batch, s, s, 3)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(1, 10, (args.batch, s, s)).astype(np.float32))
    images, depth = images.to(args.device), depth.to(args.device)
    res = {"ranks": n, "backend": mh.cluster().backend, "reason": mh.cluster().reason,
           "batch": args.batch}

    def timed_steps(state, step, x, d) -> tuple[float, float | None]:
        step(state, x, d)  # warm-up
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, x, d)
            sync()
        return ((time.perf_counter() - t0) / args.steps,
                torch.cuda.max_memory_allocated() if cuda else None)

    if rank == 0:  # one rank alone on the whole global batch
        optimizer = step_module.make_optimizer(1e-4)
        state, step = step_module.init_train(params, cfg, args.device, None, optimizer, bf16)
        sec, peak = timed_steps(state, step, images, depth)
        res["one rank s/step"], res["one rank samples/s"] = sec, args.batch / sec
        res["one rank peak bytes"] = peak
        del state, step
        if cuda:
            torch.cuda.empty_cache()
    mh.barrier()

    comm = {}
    real = {name: getattr(mh, name) for name in COLLECTIVES}

    def timed_comm(name):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            sync()
            c = comm.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    for text in args.modes:
        kw = parse_mode(text)
        if "pp" in kw:
            kw["microbatches"] = args.microbatches
        state, step = step_module.make_train_step(params, cfg, args.device, lr=1e-4,
                                                  precision=bf16, **kw)
        rows = mh.local_rows(batch_sharding(state.layout.mesh), (args.batch,))
        x, d = images[rows[0]:rows[-1] + 1], depth[rows[0]:rows[-1] + 1]
        sec, peak = timed_steps(state, step, x, d)
        comm.clear()
        for name in COLLECTIVES:
            setattr(mh, name, timed_comm(name))
        try:
            step(state, x, d)
            sync()
        finally:
            for name in COLLECTIVES:
                setattr(mh, name, real[name])
        peaks = [None] * n
        dist.all_gather_object(peaks, peak, group=mh.cluster().host_group)
        res[f"{text} s/step"], res[f"{text} samples/s"] = sec, args.batch / sec
        res[f"{text} peak bytes per rank"] = peaks
        res[f"{text} collectives per step"] = {k: c[0] for k, c in comm.items()}
        res[f"{text} collective ms per step"] = sum(c[1] for c in comm.values())
        del state, step
        if cuda:
            torch.cuda.empty_cache()
        mh.barrier()
    if rank == 0:
        print("RESULT " + json.dumps(res), flush=True)
    mh.barrier()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (default: the visible cards, or 2 on the CPU)")
    ap.add_argument("--batch", type=int, default=4, help="the global batch")
    ap.add_argument("--steps", type=int, default=3, help="timed steps per mode")
    ap.add_argument("--modes", nargs="+", default=["dp=4", "dp=2,tp=2", "dp=2,pp=2", "pp=4"])
    ap.add_argument("--microbatches", type=int, default=5)
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
            raise SystemExit("torch_train_parallel_probe: no CUDA device")
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
    print(f"{n} ranks, tensor collectives on {res['backend']} ({res['reason']}); {args.model}, "
          f"bf16, global batch {args.batch}, {args.steps} timed steps per mode, on "
          f"{card(args.device)}")
    for k, v in res.items():
        if k not in ("ranks", "backend", "reason", "batch"):
            print(f"  {k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
