"""Closed stream of frames held in memory through a runner's ``depth_stream``.

The configuration's family (``ctx.family``) makes the weights and builds the
runner, whose ``depth_stream`` yields one answer a frame, and counts the
program's kernel launches; a sample key is the frame's id in the pool, and
its input the frame.

Parameters (the mix's data file): ``batch``, ``height``, ``width``, ``pool``
(distinct seeded frames, cycled), ``warmup_batches`` (batches of the stream
that run before the window, in set-up), ``trace_batches`` (batches in the
profiled slice of a ``--trace 1`` run), ``sample`` (answers checked).

One stream runs from set-up through the window: the window opens when the
last warm-up batch has reached the host and closes at the first batch that
reaches the host at or after ``--seconds``; ``frames_per_s`` is every frame
that reached the host in between over that time. A traced run profiles
from the window's first batch on and reads ``trace_batches`` whole batches,
from one batch's upload to the device to the upload ``trace_batches`` later.
"""

from __future__ import annotations

import threading
import time

from portbench import trace
from portbench.correct import Sampler
from portbench.frames import make_frames
from portbench.run import Outcome, free, peak_bytes


def measure(ctx, runner, pool, batch: int) -> dict:
    """Warm up, then run the window on ``runner``'s stream over ``pool``.
    Returns the window's readings; the stream is closed, and the runner's
    state is the caller's to drop."""
    tr = ctx.traffic
    stop = threading.Event()

    def source():
        i = 0
        while not stop.is_set():
            yield pool[i % len(pool)]
            i += 1

    stream = runner.depth_stream(source())
    ctx.teardown.add("streams", "depth_stream", stream.close)
    ctx.teardown.add("streams", "frame source", stop.set)
    done = 0
    for _ in range(tr["warmup_batches"] * batch):
        next(stream)
        done += 1
    sampler = Sampler(tr["sample"], ctx.seed)
    counted = 0
    before = ctx.family.launches()
    capture = None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    t_end = None
    for out in stream:
        counted += 1
        sampler.offer(done % len(pool), lambda: ctx.family.sample(out))
        done += 1
        if counted % batch:
            continue
        now = time.perf_counter()
        n_batches = counted // batch
        if ctx.trace and n_batches == 1:
            capture = trace.Capture().start()
        elif capture is not None and n_batches == tr["trace_batches"] + 4:
            capture.stop()
        if now >= deadline:
            t_end = now
            break
    after = ctx.family.launches()
    if capture is not None:
        capture.stop()
    stop.set()
    stream.close()
    batches = counted // batch
    ctx.log(f"window: {counted} frames in {batches} batches over {t_end - t0:.6f} s; launches "
            f"per batch {', '.join(f'{k} {(after[k] - before[k]) / batches:g}' for k in after)}")
    sl = None
    if capture is not None:
        # a batch's upload to the card marks its start in the trace
        sl = trace.read(capture.result(), marker_bytes=batch * pool[0].size,
                        frames_per_batch=batch,
                        max_batches=tr["trace_batches"])
    return {"t0": t0, "frames": counted, "seconds": t_end - t0, "slice": sl,
            "samples": sampler.items}


def run(ctx) -> Outcome:
    tr = ctx.traffic
    batch = tr["batch"]
    pool = make_frames(tr["pool"], tr["height"], tr["width"], ctx.seed, ctx.device)
    weights = ctx.family.make_weights(ctx.arch, ctx.seed, ctx.device)
    runner = ctx.family.build_runner(ctx.config, weights, batch, ctx.device,
                                     quantize=ctx.control)
    del weights
    got = measure(ctx, runner, pool, batch)
    memory_peak = peak_bytes(ctx.device)
    del runner
    free(ctx.device)
    return Outcome(e2e={"frames_per_s": got["frames"] / got["seconds"]}, window_start=got["t0"],
                   attempted=got["frames"], failed=0, memory_peak=memory_peak,
                   samples=got["samples"], inputs={i: pool[i] for i, _ in got["samples"]},
                   slice=got["slice"])
