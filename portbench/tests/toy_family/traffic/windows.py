"""Closed stream of seeded frames through a windowed runner's ``depth_stream``.

Parameters: ``height``, ``width``, ``pool`` (distinct frames, cycled),
``sample`` (answers checked). One window runs before the window of time
opens; ``frames_per_s`` is every answer in the window over its time. A
sample key is ``(start, position)``, and its input the window's frames and
the position.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.correct import Sampler
from portbench.frames import make_frames
from portbench.run import Outcome, free, peak_bytes


def run(ctx) -> Outcome:
    tr, fam, arch = ctx.traffic, ctx.family, ctx.arch
    pool = make_frames(tr["pool"], tr["height"], tr["width"], ctx.seed, ctx.device)
    runner = fam.build_runner(ctx.config, fam.make_weights(arch, ctx.seed, ctx.device), 1,
                              ctx.device, quantize=ctx.control)
    stream = runner.depth_stream(pool[i % len(pool)] for i in range(10 ** 9))
    ctx.teardown.add("streams", "depth_stream", stream.close)
    for _ in range(arch.window):
        next(stream)
    sampler = Sampler(tr["sample"], ctx.seed)
    before = fam.launches()
    t0 = time.perf_counter()
    counted = 0
    for out in stream:
        counted += 1
        sampler.offer((out["start"], out["position"]), lambda: fam.sample(out))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    seconds = time.perf_counter() - t0
    stream.close()
    ctx.log(f"window: {counted} answers, launches {fam.launches()['windows'] - before['windows']}")
    inputs = {(s, p): (np.stack([pool[(s + j) % len(pool)] for j in range(arch.window)]), p)
              for (s, p), _ in sampler.items}
    memory_peak = peak_bytes(ctx.device)
    del runner
    free(ctx.device)
    return Outcome(e2e={"frames_per_s": counted / seconds}, window_start=t0, attempted=counted,
                   failed=0, memory_peak=memory_peak, samples=sampler.items, inputs=inputs)
