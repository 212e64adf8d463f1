"""Resident-model streaming depth runner on one device.

Twin of ``ml_depth_pro_video_tpu/video/runner.py::DepthVideoRunner``: one
resident model; a host loader decodes upcoming frames in order while the
device computes; frames ride the leading batch dim; uint8 frames are
uploaded and normalized on the device. Up to ``pipeline_depth`` batches
are dispatched ahead: each batch's device-to-host copy is queued into
pinned host memory right behind its own compute, so fetching batch N
overlaps the compute of batch N+1.

``speed`` picks the exact path or a ToMe speed tier (``balanced``,
``fast``: ``models/depth_pro.py::apply_speed``). ``temporal_smooth > 0``
smooths the stream in playback order (``video/temporal.py``) and
``fetch_pack="u16"`` fetches log-u16 codes instead of fp32 depth
(``video/pack.py``): both run on the device right behind their batch's
compute, and the host unpacks at collect time. ``quantize=True`` stores the
ViTs' block matmul weights as int8 with per-channel scales
(``ckpt/quantize.py``). ``exported_path`` serves full uint8 batches at the
artifact's shape through a ``torch.export`` program (``ckpt/export.py``);
on the card it currently builds and runs slower than eager code (a longer
first batch from the artifact's load, and fewer frames/s: PERF.md,
ROADMAP B8), so it pins the validated program rather than speeding it up.
Options of the JAX runner that this port does not implement yet (meshes and
latency parallelism: ROADMAP A item 10) raise ``NotImplementedError`` when
set.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from ..ckpt.export import load_exported, user_inputs
from ..ckpt.quantize import quantize_vit_weights
from ..core.precision import disable_tf32, resolve_device, resolve_precision
from ..io.image import load_stream_item
from ..models.depth_pro import (
    DEFAULT_MONODEPTH_CONFIG,
    DepthProConfig,
    DepthProModel,
    apply_speed,
    build_params,
    infer_fn,
)
from ..utils.compile_cache import enable_compilation_cache
from . import pack, temporal

LOGGER = logging.getLogger(__name__)
_STREAM_ERROR = "__stream_error__"


def _image_part(item):
    return item[0] if isinstance(item, tuple) else item


def _is_device_error(exc: BaseException) -> bool:
    """A CUDA runtime failure worth a bounded retry (not a kernel's own
    launch-configuration error, which is deterministic)."""
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(exc, torch.cuda.OutOfMemoryError) or (accel and isinstance(exc, accel)):
        return True
    return type(exc) is RuntimeError and "CUDA error" in str(exc)


@dataclasses.dataclass
class _Flight:
    """One dispatched batch, from dispatch to collect."""

    keys: list
    images: list
    n: int                # real frames; the rest of the batch is padding
    inputs: tuple         # (uint8 frames, f_px or None, mixed): what a retry re-dispatches
    out: dict             # the model's device outputs
    pre_state: object     # the EMA state this batch was smoothed from (None: smoothing off)
    post_state: object    # ... and the state it left
    fetch: tuple          # (host tensors, CUDA event or None)


class DepthVideoRunner:
    """Streaming batched depth inference with host/device overlap."""

    def __init__(
        self,
        cfg: DepthProConfig = DEFAULT_MONODEPTH_CONFIG,
        precision="bf16",
        batch_size: int = 1,
        downscale_factor: float = 1.0,
        mesh=None,
        prefetch: int = 2,
        rng_seed: int = 0,
        quantize: bool = False,
        max_retries: int = 2,
        parallel: str = "dp",
        speed: str = "exact",
        decode_workers: int | None = None,
        pipeline_depth: int = 2,
        exported_path: str | None = None,
        temporal_smooth: float = 0.0,
        fetch_pack: str = "none",
        decode_pool: str = "auto",
        device="cuda",
    ):
        if parallel not in ("dp", "latency"):
            raise ValueError(f"parallel must be 'dp' or 'latency', got {parallel!r}")
        if fetch_pack not in ("none", "u16"):
            raise ValueError(f"fetch_pack must be 'none' or 'u16', got {fetch_pack!r}")
        if decode_pool not in ("auto", "thread", "process"):
            raise ValueError(f"decode_pool must be 'auto', 'thread' or 'process', "
                             f"got {decode_pool!r}")
        if not 0.0 <= float(temporal_smooth) < 1.0:
            raise ValueError(f"temporal_smooth must be in [0, 1), got {temporal_smooth}")
        for name, is_set in (("mesh", mesh is not None), ("parallel='latency'", parallel != "dp")):
            if is_set:
                raise NotImplementedError(f"DepthVideoRunner({name}) is not ported to the "
                                          "PyTorch runner yet: ROADMAP A item 10 (parallel/ on "
                                          "torch.distributed)")
        if speed != "exact":
            cfg = apply_speed(cfg, speed)
        # inductor's FX-graph cache for compiled programs, as the JAX runner
        # configures XLA's (utils/compile_cache.py; off without a card)
        enable_compilation_cache()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.cfg = cfg
        self.precision = resolve_precision(precision)
        self.batch_size = batch_size
        self.downscale_factor = downscale_factor
        self.prefetch = prefetch
        self.max_retries = max_retries
        if decode_workers is None:
            decode_workers = min(8, os.cpu_count() or 1)
        self.decode_workers = max(int(decode_workers), 1)
        if decode_pool == "auto":
            decode_pool = ("process" if self.decode_workers >= 4 and (os.cpu_count() or 1) >= 4
                           else "thread")
        self.decode_pool = decode_pool
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.temporal_smooth = float(temporal_smooth)
        self.fetch_pack = fetch_pack
        params = build_params(cfg, self.device, rng_seed)
        if quantize:
            params = quantize_vit_weights(params)
        self.model = DepthProModel(params, cfg).eval()
        self.params = self.model.tree()
        # the exported program (ckpt/export.py) serves uint8 batches at its
        # exact shape without per-frame f_px; everything else runs eagerly
        self._program = None
        self.exported_calls = 0
        if exported_path is not None:
            exported = load_exported(exported_path, cfg, self.precision, quantize=quantize,
                                     n_devices=1, device=self.device)
            self._program = exported.module()
            self._exported_shape = tuple(user_inputs(exported)[-1].shape)
            self._eager_keys: set = set()
            if self._exported_shape[0] != self.batch_size:
                LOGGER.warning("exported artifact batch=%d but runner batch_size=%d: full "
                               "batches will run eagerly instead of through the artifact "
                               "(re-export with --batch_size %d)", self._exported_shape[0],
                               self.batch_size, self.batch_size)

    # ------------------------------------------------------------------
    def _infer(self, xs: np.ndarray, f_arr: np.ndarray | None, mixed: bool) -> dict:
        """Upload a uint8 batch, normalize on the device and queue the model.
        Returns device tensors (the computation may still be running)."""
        x = torch.from_numpy(xs)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        if self._program is not None:
            key = (tuple(x.shape), x.dtype, f_arr is not None, mixed)
            if key == (self._exported_shape, torch.uint8, False, False):
                self.exported_calls += 1
                with torch.inference_mode():
                    return self._program(self.params, x)
            if key not in self._eager_keys:
                # without a notice, frames at another size would quietly
                # never reach the artifact
                self._eager_keys.add(key)
                LOGGER.warning("exported artifact does not serve this batch (shape %s dtype %s, "
                               "f_px=%s, mixed=%s; artifact wants %s uint8, no per-frame "
                               "f_px): running eagerly", *key, self._exported_shape)
        x = x.float() / 127.5 - 1.0
        f = None if f_arr is None else torch.from_numpy(f_arr).to(self.device)
        with torch.inference_mode():
            return infer_fn(self.params, x, f, self.cfg, self.precision, derive_missing=mixed)

    def _post(self, out: dict, state, n: int):
        """Queue the post-ops on the device behind the batch's compute: the
        EMA over its first ``n`` rows from ``state``, then the u16 pack.
        Returns (the new state, the tensors to fetch: depth or its packed
        parts, then f_px). Nothing here waits for the card."""
        depth = out["depth"]
        with torch.inference_mode():
            if self.temporal_smooth > 0.0:
                state, depth = temporal.smooth_batch(state, depth, n,
                                                     alpha=self.temporal_smooth)
            parts = pack.pack_depth_u16(depth) if self.fetch_pack == "u16" else (depth,)
        return state, (*parts, out["focallength_px"])

    def _start_fetch(self, tensors):
        """Queue the device-to-host copies right behind the batch's post-ops
        (pinned buffers, one event); nothing waits here."""
        if self.device.type != "cuda":
            return tensors, None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _run(self, inputs: tuple, state, n: int):
        """Dispatch one batch (compute, post-ops from ``state``, fetch) with
        bounded retries on CUDA runtime errors. Returns (out, new state, fetch)."""
        delay = 5.0
        for attempt in range(self.max_retries + 1):
            try:
                out = self._infer(*inputs)
                new_state, parts = self._post(out, state, n)
                return out, new_state, self._start_fetch(parts)
            except Exception as exc:  # noqa: BLE001 - filtered just below
                if not _is_device_error(exc) or attempt == self.max_retries:
                    raise
                LOGGER.warning("device inference failed (attempt %d/%d): %s - retrying in "
                               "%.0fs", attempt + 1, self.max_retries, exc, delay)
                time.sleep(delay)
                delay = min(delay * 2, 60.0)

    def _load_one(self, item):
        return load_stream_item(item, self.downscale_factor)

    def depth_stream(self, items: Iterable) -> Iterator[dict]:
        """Yield {"key", "depth", "focallength_px", "image"} per frame, in
        input order. Frames are grouped into device batches of
        ``batch_size``; a short tail batch is padded by repeating its last
        frame. Frames without a focal length get it from the FOV head. With
        ``temporal_smooth > 0`` each stream starts a fresh EMA state."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch * max(self.batch_size, 1))
        sentinel = object()
        stop = threading.Event()

        def put(entry) -> bool:
            while not stop.is_set():
                try:
                    q.put(entry, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def loader():
            # bounded-in-flight, order-preserving decode pool; a corrupt
            # frame is skipped with a warning, never fatal
            import contextlib
            from concurrent.futures import ThreadPoolExecutor
            from concurrent.futures.process import BrokenProcessPool

            pex = None
            try:
                if self.decode_pool == "process":
                    import multiprocessing
                    from concurrent.futures import ProcessPoolExecutor

                    # spawn: children import only io.image (numpy, Pillow)
                    pex = ProcessPoolExecutor(self.decode_workers,
                                              mp_context=multiprocessing.get_context("spawn"))
                with ThreadPoolExecutor(self.decode_workers) as ex, \
                        (pex or contextlib.nullcontext()):
                    dq: deque = deque()
                    it = iter(items)
                    exhausted = False
                    while (dq or not exhausted) and not stop.is_set():
                        while not exhausted and len(dq) < 2 * self.decode_workers:
                            try:
                                item = next(it)
                            except StopIteration:
                                exhausted = True
                                break
                            if pex is not None and isinstance(_image_part(item),
                                                              (str, os.PathLike)):
                                fut = pex.submit(load_stream_item, item, self.downscale_factor)
                            else:
                                fut = ex.submit(self._load_one, item)
                            dq.append((item, fut))
                        if dq:
                            item, fut = dq.popleft()
                            try:
                                frame = fut.result()
                            except BrokenProcessPool as exc:
                                raise RuntimeError("decode worker pool died") from exc
                            except Exception as exc:  # noqa: BLE001 - skip the frame
                                LOGGER.warning("skipping unreadable frame %r: %s", item, exc)
                                continue
                            put(frame)
            except Exception as exc:  # noqa: BLE001 - surface to the consumer
                put((_STREAM_ERROR, exc))
            finally:
                put(sentinel)

        thread = threading.Thread(target=loader, daemon=True)
        thread.start()

        pending: list = []
        in_flight: deque = deque()  # _Flight, oldest first
        smoothing = self.temporal_smooth > 0.0
        # the EMA state threads through dispatch, which runs in playback order
        smooth_state = None
        # the state left by the last collected flight: its fetch proved it
        # clean. A flight's own pre_state may be poisoned (a failed
        # computation poisons what is chained onto it), so retries re-smooth
        # from here.
        collect_state = None

        def dispatch() -> _Flight:
            nonlocal pending, smooth_state
            n = len(pending)
            keys = [p[0] for p in pending]
            imgs = [p[1] for p in pending]
            xs = np.stack(imgs)
            fs = [p[2] for p in pending]
            pad = self.batch_size - n if n < self.batch_size else 0
            if pad:
                xs = np.concatenate([xs, np.repeat(xs[-1:], pad, axis=0)])
            have_f = [f is not None for f in fs]
            mixed = any(have_f) and not all(have_f)
            f_arr = None
            if any(have_f):
                # mixed batches: NaN marks frames whose f_px the FOV head derives
                fs = [np.nan if f is None else f for f in fs]
                f_arr = np.asarray(fs + [fs[-1]] * pad, np.float32)
            pending = []
            inputs = (xs, f_arr, mixed)
            pre_state = smooth_state
            out, smooth_state, fetch = self._run(inputs, pre_state, n)
            return _Flight(keys, imgs, n, inputs, out, pre_state, smooth_state, fetch)

        def heal(state) -> None:
            """Re-chain the later flights' post-ops from a repaired state: if
            the failure was a poisoned computation, their smoothing (chained
            onto it at dispatch) is poisoned too, and so is the state that
            the next dispatch would take. Their own compute is reused. A
            flight whose post-ops fail again stops the walk; its own collect
            retries it."""
            nonlocal smooth_state
            healed = 0
            try:
                for later in in_flight:
                    later.pre_state = state
                    state, parts = self._post(later.out, state, later.n)
                    later.post_state, later.fetch = state, self._start_fetch(parts)
                    healed += 1
            except Exception as exc:  # noqa: BLE001 - filtered just below
                if not _is_device_error(exc):
                    raise
            if healed == len(in_flight):
                smooth_state = state

        def collect(flight: _Flight):
            nonlocal collect_state
            delay = 5.0
            for attempt in range(self.max_retries + 1):
                try:
                    host, done = flight.fetch
                    if done is not None:
                        done.synchronize()
                    fetched = [t.numpy()[:flight.n] for t in host]
                    break
                except Exception as exc:  # noqa: BLE001 - filtered just below
                    if not _is_device_error(exc) or attempt == self.max_retries:
                        raise
                    LOGGER.warning("device fetch failed (attempt %d/%d): %s - re-dispatching "
                                   "in %.0fs", attempt + 1, self.max_retries, exc, delay)
                    time.sleep(delay)
                    delay = min(delay * 2, 60.0)
                    # the EMA advances once per frame: re-smooth from the last
                    # collected state (the saved pre_state only before any)
                    base = flight.pre_state if collect_state is None else collect_state
                    flight.out, flight.post_state, flight.fetch = self._run(
                        flight.inputs, base, flight.n)
                    flight.pre_state = base
                    if smoothing:
                        heal(flight.post_state)
            collect_state = flight.post_state
            *depth_parts, fl = fetched
            depth = (pack.unpack_depth_u16(*depth_parts) if self.fetch_pack == "u16"
                     else depth_parts[0])
            return [{"key": flight.keys[i], "depth": depth[i], "focallength_px": float(fl[i]),
                     "image": flight.images[i]} for i in range(flight.n)]

        try:
            while True:
                got = q.get()
                if got is sentinel:
                    break
                if isinstance(got, tuple) and len(got) == 2 and got[0] == _STREAM_ERROR:
                    raise RuntimeError("frame source iterator failed") from got[1]
                key, x, f = got
                if pending and x.shape != pending[0][1].shape:
                    # resolution change mid-stream: flush the homogeneous batch
                    in_flight.append(dispatch())
                    while len(in_flight) > self.pipeline_depth:
                        yield from collect(in_flight.popleft())
                pending.append((key, x, f))
                if len(pending) >= self.batch_size:
                    in_flight.append(dispatch())  # the device starts batch N+k ...
                    while len(in_flight) > self.pipeline_depth:
                        yield from collect(in_flight.popleft())  # ... while N is fetched
            if pending:
                in_flight.append(dispatch())
            while in_flight:
                yield from collect(in_flight.popleft())
        finally:
            stop.set()
            thread.join(timeout=10.0)

    def infer_one(self, item) -> dict:
        for result in self.depth_stream([item]):
            return result
        raise ValueError(f"could not read frame {item!r} (see log for the cause)")
