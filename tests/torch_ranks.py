"""Spawn a real ``torch.distributed`` gloo group of N CPU processes for a test.

Every rank runs one worker script (``python worker.py rank n port *args``)
on a free local port of its own, so parallel test workers never share a
group; each rank's output goes to a file (a full pipe could stall a rank
inside a collective). The workers import torch and the port only.
"""

import os
import socket
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the worker's preamble: argv, the repo on the path, one thread, the group joined
PREAMBLE = f"""
import sys
sys.path.insert(0, {REPO!r})
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
args = sys.argv[4:]
import torch
torch.set_num_threads(1)
from ml_depth_pro_video_tpu_torch.parallel import multihost as mh
"""
JOIN = 'assert mh.initialize(f"127.0.0.1:{port}", n, rank, device="cpu")\n'


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def spawn(script: str, n: int, *args, timeout: float = 300.0, join: bool = True) -> list[str]:
    """Run ``script`` (after the preamble, and the group join unless ``join``
    is False) on ``n`` ranks; return each rank's output. A rank that fails or
    hangs fails the test with every rank's output."""
    ranks = run(script, n, *args, timeout=timeout, join=join)
    for r, (rc, out) in enumerate(ranks):
        assert rc == 0, f"rank {r} failed:\n{out}"
    return [out for _, out in ranks]


def run(script: str, n: int, *args, timeout: float = 300.0,
        join: bool = True) -> list[tuple[int, str]]:
    """:func:`spawn` without the exit codes' check: each rank's (exit code,
    output). A group that hangs still fails the test."""
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank_worker.py")
        with open(path, "w") as f:
            f.write(PREAMBLE + (JOIN if join else "") + script)
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, path, str(r), str(n), port, *map(str, args)],
                                  stdout=log, stderr=subprocess.STDOUT, text=True, env=env,
                                  cwd=REPO)
                 for r, log in enumerate(logs)]
        hung = False
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            hung = True
            for p in procs:
                p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    if hung:
        pytest.fail(f"{n}-rank group hung:\n" + "\n".join(outs))
    return [(p.returncode, out) for p, out in zip(procs, outs)]
