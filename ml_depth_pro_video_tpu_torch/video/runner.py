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

Across ranks (``parallel/``, one process per device): with ``mesh=`` and
``parallel="dp"`` every rank reads the same stream, computes its rows of
each batch (``parallel/spmd.py``) and yields every frame after the gather;
with ``parallel="latency"`` every rank computes each batch together with
the others (``parallel/latency.py``). ``depth_stream_multihost`` is the pod
stream: each rank decodes and yields only its own rows. Every rank calls
the same method with the same items in the same order.

With a ``models/video_depth_anything.py::VDAConfig`` as ``cfg`` the runner
runs Video Depth Anything instead: ``depth_stream`` runs windows of
``cfg.window`` frames (32), the first ``cfg.overlap`` of each the window
before's inputs at ``cfg.keyframes``, kept on the device, so that each
window after the first uploads only its new frames (22), in one copy. It
yields one answer a frame, in order: ``{"key", "inverse_depth" (H, W) fp32
relative inverse depth at the frame's size, "window", "position" (the
window and the position in it where the frame was new), "image"}``. With
``stitch=True`` (upstream's ``infer_video_depth``) each window is aligned to
the stitched stream by a scale and shift and blended into its overlap on the
device (``stitch_window``), and a window's last 8 frames wait for the next
window's blend; with ``stitch=False`` each frame is its window's raw output.
The loader thread, staging, up to ``pipeline_depth`` windows in flight, the
pinned fetch and the spans below are the same as for Depth Pro's batches
(a window is a span's ``#seq``); retries, meshes, artifacts and the
post-ops are Depth Pro's only.

While a ``torch.profiler`` runs, ``depth_stream`` marks what its thread is
doing with five spans (``utils/profiling.py::span``) that tile its loop:
``depth_stream.wait_frames`` (blocked on the loader's queue), ``.stage``
(the batch stacked, padded, pinned, uploaded and normalized), ``.launch``
(the model, the post-ops and the fetch enqueued, retries included),
``.collect`` (waiting for a fetch and unpacking it) and ``.caller``
(suspended at the yields of a collected batch), each named
``<span>#<batch>``. Each phase ends the one before it, so they never nest
or overlap; with no profiler running each costs a flag read.
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

from ..ckpt.convert_vda import build_vda_params
from ..ckpt.export import load_exported, user_inputs
from ..ckpt.quantize import quantize_vit, quantize_vit_weights
from ..core.precision import disable_tf32, resolve_device, resolve_precision
from ..io.image import load_stream_item
from ..models import video_depth_anything as vda
from ..models.depth_pro import (
    DEFAULT_MONODEPTH_CONFIG,
    DepthProConfig,
    DepthProModel,
    apply_speed,
    build_params,
    infer_fn,
)
from ..parallel import multihost
from ..parallel.latency import make_latency_infer, make_sp_mesh
from ..parallel.mesh import batch_sharding, round_batch_to_dp
from ..parallel.spmd import make_dp_infer
from ..utils.compile_cache import enable_compilation_cache
from ..utils.profiling import span
from . import pack, temporal

LOGGER = logging.getLogger(__name__)
_STREAM_ERROR = "__stream_error__"


class _Phase(threading.local):
    """The phase that a runner's ``depth_stream`` is in on this thread, and
    its span.

    ``enter`` ends the open span and opens the next, so the stream's spans
    tile its loop without nesting. ``move`` is for code that the stream
    calls (``_forward``): it switches the phase and keeps the batch, and
    only inside a stream, so that other callers open no span."""

    name = None   # the phase, or None outside depth_stream
    seq = None    # the batch it works for
    open = None   # the phase's entered span

    def enter(self, name: str, seq) -> None:
        if name == self.name and seq == self.seq:
            return
        self.end()
        self.name, self.seq = name, seq
        self.open = span(f"depth_stream.{name}", seq)
        self.open.__enter__()

    def move(self, name: str) -> None:
        if self.name is not None:
            self.enter(name, self.seq)

    def end(self) -> None:
        opened, self.open, self.name = self.open, None, None
        if opened is not None:
            opened.__exit__(None, None, None)


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
    seq: int              # the batch's number in its stream


@dataclasses.dataclass
class _WindowFlight:
    """One dispatched Video Depth Anything window, from dispatch to collect."""

    seq: int              # the window's number in its stream
    meta: list            # (key, image, window, position) of each fetched row
    fetch: tuple          # (host tensors, CUDA event or None)


class DepthVideoRunner:
    """Streaming batched depth inference with host/device overlap."""

    _vda = None  # the Video Depth Anything model of a runner built on a VDAConfig

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
        params: dict | None = None,
        stitch: bool = True,
    ):
        """``params``: the model's param tree (default: the checkpoint's, or
        random weights from ``rng_seed``). ``stitch``: Video Depth
        Anything's stitching of windows (its ``cfg`` only)."""
        is_vda = isinstance(cfg, vda.VDAConfig)
        if is_vda and (mesh is not None or exported_path is not None or speed != "exact"
                       or temporal_smooth or fetch_pack != "none"):
            raise ValueError("Video Depth Anything runs on one device, eagerly, at its exact "
                             "path, without the temporal smoother or the packed fetch")
        if parallel not in ("dp", "latency"):
            raise ValueError(f"parallel must be 'dp' or 'latency', got {parallel!r}")
        if fetch_pack not in ("none", "u16"):
            raise ValueError(f"fetch_pack must be 'none' or 'u16', got {fetch_pack!r}")
        if decode_pool not in ("auto", "thread", "process"):
            raise ValueError(f"decode_pool must be 'auto', 'thread' or 'process', "
                             f"got {decode_pool!r}")
        if not 0.0 <= float(temporal_smooth) < 1.0:
            raise ValueError(f"temporal_smooth must be in [0, 1), got {temporal_smooth}")
        if exported_path is not None and mesh is not None and parallel != "dp":
            raise ValueError("exported_path serves the single-device and dp-mesh paths; "
                             "latency-parallel programs run eagerly")
        if exported_path is not None and multihost.host_count() > 1:
            # a host's ranks stand for the JAX package's one process over its chips
            raise ValueError("exported_path is single-host only; ranks on several hosts run "
                             "eagerly")
        if mesh is not None and parallel == "dp":
            # dispatch pads partial batches to batch_size anyway
            batch_size = round_batch_to_dp(batch_size, mesh)
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
        # "dp": frames split over the mesh's ranks (throughput); "latency":
        # the model split over them (one stream's latency, best at batch 1)
        self.mesh = mesh
        self.parallel = parallel
        self.prefetch = prefetch
        if mesh is not None and multihost.world_size() > 1 and max_retries:
            # a retry on one rank alone would desync the others' collectives
            LOGGER.info("runner over %d ranks: device errors are not retried",
                        multihost.world_size())
            max_retries = 0
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
        self._phase = _Phase()
        if is_vda:
            params = build_vda_params(cfg, self.device, rng_seed) if params is None else params
            if quantize:
                params = {**params, "vit": quantize_vit(params["vit"])}
            self._vda = vda.VideoDepthAnything(params, cfg)
            self.params = self._vda.params
            self.stitch = bool(stitch)
            self.model = self._program = self._dp = self._latency = None
            return
        if params is None:
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
            # a dp-mesh runner serves the per-rank program of depth-pro-export-torch --dp N
            exported = load_exported(exported_path, cfg, self.precision, quantize=quantize,
                                     n_devices=1 if mesh is None else mesh.size,
                                     device=self.device)
            self._program = exported.module()
            self._exported_shape = tuple(user_inputs(exported)[-1].shape)
            self._eager_keys: set = set()
            dp = 1 if mesh is None else mesh.shape["dp"]
            if self._exported_shape[0] * dp != self.batch_size:
                LOGGER.warning("exported artifact batch=%d per rank but runner batch_size=%d "
                               "over dp=%d: full batches will run eagerly instead of through "
                               "the artifact (re-export with --batch_size %d)",
                               self._exported_shape[0], self.batch_size, dp, self.batch_size)
        # the programs over the mesh's ranks: dp cuts the batch to this rank's
        # rows and gathers the result; latency splits each forward (one
        # program per value of derive_missing)
        self._dp = self._latency = None
        if mesh is not None and parallel == "dp":
            self._dp = make_dp_infer(lambda _, x, f, mixed: self._forward(x, f, mixed), mesh, 2)
        elif mesh is not None:
            self._latency = {mixed: make_latency_infer(cfg, make_sp_mesh(mesh.ranks),
                                                       self.precision, derive_missing=mixed)
                             for mixed in (False, True)}

    # ------------------------------------------------------------------
    def _infer(self, xs: np.ndarray, f_arr: np.ndarray | None, mixed: bool) -> dict:
        """The model on a whole uint8 batch: on this device, on this rank's rows
        and gathered (dp mesh), or split over the ranks (latency). Returns
        device tensors (the computation may still be running)."""
        if self._dp is not None:
            return self._dp(self.params, xs, f_arr, mixed)
        return self._forward(xs, f_arr, mixed)

    def _forward(self, xs: np.ndarray, f_arr: np.ndarray | None, mixed: bool) -> dict:
        """Upload uint8 frames, normalize on the device and queue the model.
        Inside ``depth_stream`` the upload is its batch's stage and the model
        its launch (on a dp mesh: this rank's rows)."""
        self._phase.move("stage")
        x = torch.from_numpy(xs)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        exported = False
        if self._program is not None:
            key = (tuple(x.shape), x.dtype, f_arr is not None, mixed)
            exported = key == (self._exported_shape, torch.uint8, False, False)
            if not exported and key not in self._eager_keys:
                # without a notice, frames at another size would quietly
                # never reach the artifact
                self._eager_keys.add(key)
                LOGGER.warning("exported artifact does not serve this batch (shape %s dtype %s, "
                               "f_px=%s, mixed=%s; artifact wants %s uint8, no per-frame "
                               "f_px): running eagerly", *key, self._exported_shape)
        if not exported:
            x = x.float() / 127.5 - 1.0
            f = None if f_arr is None else torch.from_numpy(f_arr).to(self.device)
        self._phase.move("launch")
        with torch.inference_mode():
            if exported:
                self.exported_calls += 1
                return self._program(self.params, x)
            if self._latency is not None:
                return self._latency[mixed](self.params, x, f)
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

    def _start_loader(self, items: Iterable, capacity: int):
        """Start the loader thread: it decodes ``items`` in order with a
        bounded pool and queues each frame, at most ``capacity`` ahead.
        Returns (the queue, the sentinel it queues last, the event that
        stops it, the thread)."""
        q: queue.Queue = queue.Queue(maxsize=capacity)
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

            try:
                with contextlib.ExitStack() as pools:
                    ex = pools.enter_context(ThreadPoolExecutor(self.decode_workers))
                    pex = None
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
                            if self.decode_pool == "process" and isinstance(
                                    _image_part(item), (str, os.PathLike)):
                                if pex is None:
                                    # started at the first path: frames in memory start
                                    # no process. spawn: children import only io.image
                                    # (numpy, Pillow)
                                    import multiprocessing
                                    from concurrent.futures import ProcessPoolExecutor

                                    pex = pools.enter_context(ProcessPoolExecutor(
                                        self.decode_workers,
                                        mp_context=multiprocessing.get_context("spawn")))
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
        return q, sentinel, stop, thread

    def depth_stream(self, items: Iterable) -> Iterator[dict]:
        """Yield {"key", "depth", "focallength_px", "image"} per frame, in
        input order. Frames are grouped into device batches of
        ``batch_size``; a short tail batch is padded by repeating its last
        frame. Frames without a focal length get it from the FOV head. With
        ``temporal_smooth > 0`` each stream starts a fresh EMA state. A
        Video Depth Anything runner streams windows instead (the module's
        docstring)."""
        if self._vda is not None:
            yield from self._window_stream(items)
            return
        q, sentinel, stop, thread = self._start_loader(
            items, self.prefetch * max(self.batch_size, 1))

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
        dispatched = 0  # batches so far: the next one's number

        def dispatch() -> _Flight:
            nonlocal pending, smooth_state, dispatched
            seq, dispatched = dispatched, dispatched + 1
            self._phase.enter("stage", seq)
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
            return _Flight(keys, imgs, n, inputs, out, pre_state, smooth_state, fetch, seq)

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
                    self._phase.enter("launch", later.seq)
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
                self._phase.enter("collect", flight.seq)
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
            results = [{"key": flight.keys[i], "depth": depth[i], "focallength_px": float(fl[i]),
                        "image": flight.images[i]} for i in range(flight.n)]
            self._phase.enter("caller", flight.seq)  # until the yields of these are done
            return results

        try:
            while True:
                self._phase.enter("wait_frames", dispatched)
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
            self._phase.end()
            stop.set()
            thread.join(timeout=10.0)

    def _window_stream(self, items: Iterable) -> Iterator[dict]:
        """``depth_stream`` of a Video Depth Anything runner: windows of
        ``cfg.window`` frames over the stream, as upstream's
        ``infer_video_depth`` cuts it (the windows start every ``cfg.step``
        frames while they start inside the stream; a window past its end is
        filled with copies of the last frame)."""
        cfg, model = self.cfg, self._vda
        keyframes = list(cfg.keyframes)
        il = cfg.interp_len
        q, sentinel, stop, thread = self._start_loader(items, self.prefetch * cfg.window)
        in_flight: deque = deque()
        pending: list = []      # (key, frame) not yet in a window
        state = {"w": 0, "carried": None, "stitch": None, "held": [None] * il, "shape": None}

        def dispatch(chunk: list, n_real: int, last: bool) -> _WindowFlight:
            seq = state["w"]
            state["w"] += 1
            self._phase.enter("stage", seq)
            xs = torch.from_numpy(np.stack([x for _, x in chunk]))
            if self.device.type == "cuda":
                xs = xs.pin_memory().to(self.device, non_blocking=True)
            fh, fw = xs.shape[1:3]
            new = vda.preprocess(xs, vda.net_hw((fh, fw), cfg.input_size, cfg.vit.patch_size))
            carried = state["carried"]
            window = new if carried is None else torch.cat([carried[keyframes], new])
            first = 0 if carried is None else cfg.overlap
            vda.COUNTERS["frames_new"] += len(chunk)
            vda.COUNTERS["frames_carried"] += cfg.window - len(chunk)
            self._phase.move("launch")
            own = {first + i: (chunk[i][0], chunk[i][1], seq, first + i) for i in range(n_real)}
            with torch.inference_mode():
                raw = model.window_forward(window, self.precision, seq)
                if self.stitch:
                    full = vda.resize_ac(raw[..., None], (fh, fw))[..., 0]
                    state["stitch"], done, pos = vda.stitch_window(state["stitch"], full, cfg,
                                                                   last)
                    held = iter(state["held"])
                    metas = [next(held) if p < 0 else own.get(p) for p in pos]
                    state["held"] = [own.get(p) for p in range(cfg.window - il, cfg.window)]
                else:
                    done = vda.resize_ac(raw[first:first + n_real, ..., None], (fh, fw))[..., 0]
                    metas = [own[first + i] for i in range(n_real)]
                rows = [i for i, m in enumerate(metas) if m is not None]
                if len(rows) < done.shape[0]:
                    done = done[rows]
            state["carried"] = window
            return _WindowFlight(seq, [metas[i] for i in rows], self._start_fetch((done,)))

        def collect(flight: _WindowFlight) -> list:
            self._phase.enter("collect", flight.seq)
            host, done = flight.fetch
            if done is not None:
                done.synchronize()
            inv = host[0].numpy()
            out = [{"key": key, "inverse_depth": inv[i], "window": w, "position": p,
                    "image": image} for i, (key, image, w, p) in enumerate(flight.meta)]
            self._phase.enter("caller", flight.seq)  # until the yields of these are done
            return out

        def launch(chunk: list, n_real: int, last: bool):
            in_flight.append(dispatch(chunk, n_real, last))
            while len(in_flight) > self.pipeline_depth:
                yield from collect(in_flight.popleft())

        seen, last_item = 0, None
        try:
            while True:
                self._phase.enter("wait_frames", state["w"])
                got = q.get()
                if got is sentinel:
                    break
                if isinstance(got, tuple) and len(got) == 2 and got[0] == _STREAM_ERROR:
                    raise RuntimeError("frame source iterator failed") from got[1]
                key, x, _ = got
                if state["shape"] is None:
                    state["shape"] = x.shape
                elif x.shape != state["shape"]:
                    raise ValueError(f"a window stream keeps one frame size: got {x.shape} "
                                     f"after {state['shape']}")
                seen += 1
                last_item = (key, x)
                pending.append(last_item)
                need = cfg.window if state["w"] == 0 else cfg.step
                if len(pending) == need:
                    yield from launch(pending, need, False)
                    pending = []
            # upstream's windows start at every multiple of step inside the
            # stream; the stitched stream needs each of them, the raw one only
            # those with frames of their own
            while seen and state["w"] * cfg.step < seen and (pending or self.stitch):
                need = cfg.window if state["w"] == 0 else cfg.step
                chunk, pending = pending[:need], pending[need:]
                n_real = len(chunk)
                chunk = chunk + [last_item] * (need - n_real)
                yield from launch(chunk, n_real, (state["w"] + 1) * cfg.step >= seen)
            while in_flight:
                yield from collect(in_flight.popleft())
        finally:
            self._phase.end()
            stop.set()
            thread.join(timeout=10.0)

    def depth_stream_multihost(self, items, should_stop=None) -> Iterator[dict]:
        """The pod stream over the ranks (``parallel/multihost.py``).

        Every rank calls this with the SAME ordered items (paths, (path,
        f_px) or arrays) and consumes them one batch of ``batch_size`` at a
        time; each rank decodes only its rows of each batch (a short tail
        batch repeats its last item), runs them on its own device with no
        collective, and yields only them, each with ``"index"``, its frame's
        number in the stream. Frames without a focal length get it from the
        FOV head.

        Contract (raised): a dp mesh; one resolution for the whole stream
        (ranks cannot see each other's frames to agree on a flush);
        ``temporal_smooth`` off (frames interleave across ranks);
        ``fetch_pack`` off. An unreadable frame becomes a zero frame, with a
        warning, and is not yielded: its row stays, so the rows stay aligned
        across ranks. ``should_stop`` (a callable, e.g. reading a SIGINT
        flag) is polled once per batch and resolved over every rank
        (``multihost.any_flag``): if any rank wants to stop, every rank stops
        dispatching at the same batch and drains what it has in flight. A
        rank must not break out of this generator on its own. A device error
        raises (it is not retried). Single-process it yields every frame.
        """
        if self.mesh is None or self.parallel != "dp":
            raise ValueError("multihost streaming requires a dp mesh")
        if self.temporal_smooth > 0.0:
            raise ValueError("temporal_smooth needs every frame in playback order on one "
                             "rank; run the depth-pro-smooth-torch post-pass instead "
                             "(video/temporal.py::smooth_depth_files)")
        if self.fetch_pack != "none":
            raise ValueError("fetch_pack is single-host only")
        from concurrent.futures import ThreadPoolExecutor
        from itertools import islice

        it = iter(items)
        size = self.batch_size
        rows = multihost.local_rows(batch_sharding(self.mesh), (size,))
        stream_shape = None

        def load_isolated(item):
            try:
                return self._load_one(item)
            except Exception as exc:  # noqa: BLE001 - zero-substituted, the rows stay aligned
                LOGGER.warning("unreadable frame %r: zero-frame substitute (multihost rows "
                               "must stay aligned): %s", item, exc)
                return None

        def decode(chunk, ex):
            """This rank's rows of one batch of ``chunk`` (1 to ``size`` items)."""
            nonlocal stream_shape
            last = len(chunk) - 1
            loaded = list(ex.map(load_isolated, (chunk[min(r, last)] for r in rows)))
            shape = stream_shape
            for entry in loaded:
                if entry is not None:
                    shape = entry[1].shape
                    break
            if shape is None:
                # every local row of the first batch is unreadable: learn the
                # shape from another item of the batch rather than strand the
                # other ranks
                tried = {min(r, last) for r in rows}
                for i, item in enumerate(chunk):
                    if i not in tried and (entry := load_isolated(item)) is not None:
                        shape = entry[1].shape
                        break
            if shape is None:
                raise ValueError("every frame of the first multihost batch is unreadable on "
                                 "this rank (see the warnings above): the stream shape cannot "
                                 "be established")
            bad = {r for r, entry in zip(rows, loaded) if entry is None}
            loaded = [(None, np.zeros(shape, np.uint8), None) if e is None else e
                      for e in loaded]
            xs = np.stack([x for _, x, _ in loaded])
            if stream_shape is not None and xs.shape[1:] != stream_shape:
                raise ValueError(f"multihost streams need one resolution; got {xs.shape[1:]} "
                                 f"after {stream_shape}")
            stream_shape = xs.shape[1:]
            fs = np.asarray([np.nan if f is None else f for _, _, f in loaded], np.float32)
            return [k for k, _, _ in loaded], [x for _, x, _ in loaded], xs, fs, bad, len(chunk)

        def dispatch(g, decoded):
            keys, imgs, xs, fs, bad, n_here = decoded
            _, parts = self._post(self._forward(xs, fs, True), None, len(rows))
            return g, keys, imgs, bad, n_here, self._start_fetch(parts)

        def collect(flight):
            g, keys, imgs, bad, n_here, (host, done) = flight
            if done is not None:
                done.synchronize()
            depth, fl = (t.numpy() for t in host)
            for i, r in enumerate(rows):
                if r < n_here and r not in bad:  # not padding, not an unreadable frame
                    yield {"key": keys[i], "index": g * size + r, "depth": depth[i],
                           "focallength_px": float(fl[i]), "image": imgs[i]}

        with ThreadPoolExecutor(self.decode_workers) as ex:
            in_flight: deque = deque()
            g = 0
            while True:
                # collective: every rank stops at the same batch or none does
                if should_stop is not None and multihost.any_flag(bool(should_stop())):
                    break
                chunk = list(islice(it, size))
                if not chunk:
                    break
                in_flight.append(dispatch(g, decode(chunk, ex)))
                g += 1
                while len(in_flight) > self.pipeline_depth:
                    yield from collect(in_flight.popleft())
            while in_flight:
                yield from collect(in_flight.popleft())

    def infer_one(self, item) -> dict:
        for result in self.depth_stream([item]):
            return result
        raise ValueError(f"could not read frame {item!r} (see log for the cause)")
