"""A run's teardown: nothing the run started may outlive it.

``Teardown`` collects what a run starts, by kind, and ends it in a fixed
order, whether the run passed or failed (the stream cells register streams
only; the other kinds are there for traffic that starts a server or ranks):

1. ``streams``: generators (a ``depth_stream``) are closed, so that their
   loader threads join and their decode pools shut down;
2. ``servers``: HTTP servers are shut down and closed with their batchers;
3. ``ranks``: the process group is destroyed and each rank process the run
   started is waited for;
4. multiprocessing's resource tracker is stopped if one was started (an
   unused spawn-context pool starts one);
5. every descendant left, read from ``/proc/<pid>/task/*/children``
   recursively, gets SIGTERM, then SIGKILL after a grace period, and is
   waited for.

Steps 4 and 5 touch only what the run started: the descendants and the
tracker already alive when the ``Teardown`` was made are spared. A run makes
it first, when it has none; a test that makes one inside its own process
leaves that process's other helpers alone.

``run()`` returns the errors its steps met, the strays step 5 ended and the
descendants still alive after it; a run with any survivor reports itself as
failed.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from pathlib import Path

ORDER = ("streams", "servers", "ranks")


def children(pid: int) -> list[int]:
    """The direct children of ``pid``, from every thread's children list."""
    out: list[int] = []
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            text = (task / "children").read_text()
        except OSError:
            continue
        out.extend(int(c) for c in text.split())
    return sorted(set(out))


def descendants(pid: int | None = None) -> list[int]:
    """Every descendant of ``pid`` (this process by default), parents first."""
    todo, seen = [os.getpid() if pid is None else pid], []
    while todo:
        for child in children(todo.pop()):
            if child not in seen:
                seen.append(child)
                todo.append(child)
    return seen


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return False
    return state not in ("Z", "X")


def _reap(pid: int) -> None:
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass


def end_processes(pids: list[int], grace: float = 5.0) -> list[int]:
    """SIGTERM each of ``pids``, SIGKILL what is left after ``grace`` seconds,
    and wait for each; returns those still alive (none, normally)."""
    for sig, wait in ((signal.SIGTERM, grace), (signal.SIGKILL, grace)):
        live = [p for p in pids if _alive(p)]
        for p in live:
            try:
                os.kill(p, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + wait
        while live and time.monotonic() < deadline:
            for p in live:
                _reap(p)
            live = [p for p in live if _alive(p)]
            if live:
                time.sleep(0.05)
        for p in pids:
            _reap(p)
        if not live:
            return []
    return [p for p in pids if _alive(p)]


def _tracker():
    rt = sys.modules.get("multiprocessing.resource_tracker")
    return getattr(rt, "_resource_tracker", None)


def tracker_pid() -> int | None:
    """The pid of this process's multiprocessing resource tracker, if running."""
    return getattr(_tracker(), "_pid", None)


def stop_resource_tracker(spare: int | None = None) -> bool:
    """Stop multiprocessing's resource tracker if this process started one,
    unless it is the one whose pid is ``spare``."""
    pid = tracker_pid()
    if pid is None or pid == spare:
        return False
    _tracker()._stop()
    return True


class Teardown:
    """What a run started, ended in ``ORDER``, then the tracker and strays."""

    def __init__(self):
        self._steps: dict[str, list] = {kind: [] for kind in ORDER}
        self._before = set(descendants())
        self._tracker_before = tracker_pid()

    def add(self, kind: str, name: str, fn) -> None:
        """Call ``fn()`` at teardown in step ``kind``; later additions of one
        kind run first (a stream opened inside a server closes before it)."""
        self._steps[kind].insert(0, (name, fn))

    def run(self) -> dict:
        errors = []
        for kind in ORDER:
            steps, self._steps[kind] = self._steps[kind], []
            for name, fn in steps:
                try:
                    fn()
                except Exception as exc:  # noqa: BLE001 - every step still runs
                    errors.append(f"{kind} {name}: {exc!r}")
        try:
            stop_resource_tracker(spare=self._tracker_before)
        except Exception as exc:  # noqa: BLE001
            errors.append(f"resource tracker: {exc!r}")
        strays = self._started()
        end_processes(strays)
        return {"errors": errors, "ended": strays,
                "survivors": sorted({p for p in self._started() + strays if _alive(p)})}

    def _started(self) -> list[int]:
        return [p for p in descendants() if p not in self._before]
