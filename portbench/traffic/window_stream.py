"""Closed stream of frames held in memory through a windowed runner's
``depth_stream``: Video Depth Anything's 32-frame windows.

The configuration's family (``ctx.family``) makes the weights and builds the
runner, whose ``depth_stream`` yields one answer a frame with the window and
the position where the frame was new; windows are not stitched, so that each
answer is its own window's output. A sample key is ``(window, position)``,
and its input the window's inputs (``family.window_frames``) and the
position.

Parameters (the mix's data file): ``height``, ``width``, ``pool`` (distinct
seeded frames, cycled), ``warmup_windows`` (windows of the stream that run
before the window of time, in set-up), ``trace_windows`` (windows in the
profiled slice of a ``--trace 1`` run), ``sample`` (answers checked).

One stream runs from set-up through the timed window: it opens when the last
answer of the last warm-up window has reached the host, and closes at the
first window whose last answer reaches the host at or after ``--seconds``;
``frames_per_s`` is every answer in between (the new frames of whole
windows) over that time. A traced run profiles from the first window
boundary of the timed window on and reads ``trace_windows`` whole windows,
from one window's upload of its new frames to the device to the upload
``trace_windows`` later. The family's counters (windows, frames encoded new
and carried, temporal K1 calls, K1 and K2 launches) are logged per window.
"""

from __future__ import annotations

import threading
import time

from portbench import trace
from portbench.correct import Sampler
from portbench.frames import make_frames
from portbench.run import Outcome, free, peak_bytes


def measure(ctx, runner, pool) -> dict:
    """Warm up, then run the timed window on ``runner``'s stream over
    ``pool``. Returns its readings; the stream is closed."""
    tr, arch, fam = ctx.traffic, ctx.arch, ctx.family
    last_pos = arch.window - 1
    stop = threading.Event()

    def source():
        i = 0
        while not stop.is_set():
            yield pool[i % len(pool)]
            i += 1

    stream = runner.depth_stream(source())
    ctx.teardown.add("streams", "depth_stream", stream.close)
    ctx.teardown.add("streams", "frame source", stop.set)
    for out in stream:
        if out["window"] == tr["warmup_windows"] - 1 and out["position"] == last_pos:
            break
    sampler = Sampler(tr["sample"], ctx.seed)
    counted = windows = 0
    before = fam.launches()
    capture = None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    t_end = None
    for out in stream:
        counted += 1
        sampler.offer((out["window"], out["position"]), lambda: fam.sample(out))
        if out["position"] != last_pos:
            continue
        windows += 1
        now = time.perf_counter()
        if ctx.trace and windows == 1:
            capture = trace.Capture().start()
        elif capture is not None and windows == tr["trace_windows"] + 4:
            capture.stop()
        if now >= deadline:
            t_end = now
            break
    after = fam.launches()
    if capture is not None:
        capture.stop()
    stop.set()
    stream.close()
    ctx.log(f"window: {counted} frames in {windows} windows over {t_end - t0:.6f} s; per window "
            f"{', '.join(f'{k} {(after[k] - before[k]) / windows:g}' for k in after)}")
    step = arch.window - arch.overlap
    sl = None
    if capture is not None:
        # a window's upload of its new frames to the card marks its start in the trace
        sl = trace.read(capture.result(), marker_bytes=step * pool[0].size,
                        frames_per_batch=step, max_batches=tr["trace_windows"])
    return {"t0": t0, "frames": counted, "seconds": t_end - t0, "slice": sl,
            "samples": sampler.items}


def run(ctx) -> Outcome:
    tr, fam, arch = ctx.traffic, ctx.family, ctx.arch
    pool = make_frames(tr["pool"], tr["height"], tr["width"], ctx.seed, ctx.device)
    weights = fam.make_weights(arch, ctx.seed, ctx.device)
    runner = fam.build_runner(ctx.config, weights, arch.window, ctx.device,
                              quantize=ctx.control, stitch=False)
    del weights
    got = measure(ctx, runner, pool)
    memory_peak = peak_bytes(ctx.device)
    del runner
    free(ctx.device)
    windows: dict = {}
    inputs = {}
    for (w, p), _ in got["samples"]:
        if w not in windows:
            windows[w] = pool[[i % len(pool) for i in fam.window_frames(w, arch)]]
        inputs[(w, p)] = (windows[w], p)
    return Outcome(e2e={"frames_per_s": got["frames"] / got["seconds"]}, window_start=got["t0"],
                   attempted=got["frames"], failed=0, memory_peak=memory_peak,
                   samples=got["samples"], inputs=inputs, slice=got["slice"])
