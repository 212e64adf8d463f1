"""A run ends with no process of its own alive: the teardown's five steps."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lifecycle import Teardown, descendants

ROOT = Path(__file__).resolve().parents[2]

# The child starts what a video cell's run starts: an unused spawn-context
# process pool, as DepthVideoRunner's loader builds for decode_pool="auto"
# (whose queue locks start multiprocessing's resource tracker), and a sleeping
# subprocess; then it runs the harness's teardown, after a run that passed or
# raised, and reports its descendants before and after.
CHILD = r"""
import json, multiprocessing, subprocess, sys
from concurrent.futures import ProcessPoolExecutor
from portbench import run
from portbench.lifecycle import descendants

def started(ctx):
    pool = ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"))
    sleeper = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    ctx.teardown.add("streams", "decode pool", lambda: pool.shutdown(wait=True))
    before = descendants()
    if RAISE:
        raise RuntimeError("the run failed")
    return {"before": before}, {}

class Ctx:
    from portbench.lifecycle import Teardown
    teardown = Teardown()

run.run_cell = lambda ctx, man, root, limits: started(ctx)
RAISE = sys.argv[1] == "raise"
result, report = run.execute(Ctx(), {})
print(json.dumps({"result": result, "report": report, "after": descendants()}))
"""


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state not in ("Z", "X")


@pytest.mark.parametrize("outcome", ["pass", "raise"])
def test_teardown_leaves_no_descendant(outcome):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", CHILD, outcome], capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["after"] == [] and out["report"]["survivors"] == []
    if outcome == "raise":
        assert out["result"] is None and "RuntimeError: the run failed" in proc.stderr
        assert out["report"]["ended"], "the sleeper and the tracker are ended by step 5"
    else:
        before = out["result"]["before"]
        assert len(before) >= 2, "the resource tracker and the sleeper ran"
        assert not any(_alive(p) for p in before)


def test_teardown_order_and_errors():
    before = set(descendants())
    calls = []
    td = Teardown()
    td.add("ranks", "group", lambda: calls.append("ranks"))
    td.add("streams", "first stream", lambda: calls.append("stream 1"))
    td.add("servers", "server", lambda: calls.append("server"))
    td.add("streams", "second stream", lambda: (_ for _ in ()).throw(OSError("broken")))
    report = td.run()
    assert calls == ["stream 1", "server", "ranks"]
    assert report["errors"] == ["streams second stream: OSError('broken')"]
    assert report["survivors"] == [] and report["ended"] == []
    assert set(descendants()) <= before


def test_teardown_spares_what_was_alive_before_it():
    # a helper of the calling process that predates the run is not the run's
    helper = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    try:
        td = Teardown()
        started = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        report = td.run()
        assert report["ended"] == [started.pid] and report["survivors"] == []
        assert started.poll() is not None
        assert helper.poll() is None and _alive(helper.pid)
    finally:
        helper.kill()
        helper.wait()
