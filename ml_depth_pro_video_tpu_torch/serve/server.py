"""Micro-batching HTTP depth server on the port's resident runner.

Twin of ``ml_depth_pro_video_tpu/serve/server.py``: a dependency-free HTTP
service around one resident ``DepthVideoRunner`` (``video/runner.py``);
concurrent requests are coalesced into one device batch. One batcher thread
drives the card; the HTTP handler threads decode, resize and encode on the
host.

Endpoints:
  GET  /healthz          -> {"status": "ok", "device": ...}
  GET  /metrics          -> Prometheus text: request/error/batch
                            counters, batch fill ratio, latency histogram
  POST /v1/depth         -> body: PNG/JPEG bytes; returns JSON
                            {depth_shape, focallength_px, min, max} plus
                            base64 npz when ?return=npz, or a 16-bit
                            grayscale PNG when ?return=png16.
                            ?session=<id>&smooth=<alpha in [0,1)>
                            applies per-stream temporal smoothing
                            (video/temporal.py) to that client's frames
                            — see :class:`_Sessions`.

``depth-pro-serve-torch`` runs it (``--device cuda`` by default).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..video.temporal import TemporalSmoother

LOGGER = logging.getLogger(__name__)

# request-latency histogram bucket upper bounds (seconds): spans the
# tiny-config path through multi-batch queueing on a cold server
_LATENCY_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
MAX_BODY = 64 * 1024 * 1024
_STOP = object()  # the batcher's queue item that ends its thread


class _Metrics:
    """Thread-safe counters + fixed-bucket latency histogram, rendered
    in the Prometheus text exposition format (GET /metrics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batches = 0
        self.frames = 0
        self.lat_sum = 0.0
        self.lat_buckets = [0] * (len(_LATENCY_BUCKETS) + 1)  # +inf tail

    def record_request(self, seconds: float, error: bool):
        with self._lock:
            self.requests += 1
            self.errors += int(error)
            self.lat_sum += seconds
            for i, ub in enumerate(_LATENCY_BUCKETS):
                if seconds <= ub:
                    self.lat_buckets[i] += 1
                    break
            else:
                self.lat_buckets[-1] += 1

    def record_batch(self, size: int):
        with self._lock:
            self.batches += 1
            self.frames += size

    def render(self, max_batch: int) -> str:
        with self._lock:
            lines = [
                "# TYPE depthpro_requests_total counter",
                f"depthpro_requests_total {self.requests}",
                "# TYPE depthpro_request_errors_total counter",
                f"depthpro_request_errors_total {self.errors}",
                "# TYPE depthpro_batches_total counter",
                f"depthpro_batches_total {self.batches}",
                "# TYPE depthpro_batch_frames_total counter",
                f"depthpro_batch_frames_total {self.frames}",
                "# TYPE depthpro_batch_fill_ratio gauge",
                "depthpro_batch_fill_ratio "
                f"{self.frames / max(self.batches * max_batch, 1):.4f}",
                "# TYPE depthpro_request_latency_seconds histogram",
            ]
            acc = 0
            for ub, n in zip(_LATENCY_BUCKETS, self.lat_buckets):
                acc += n
                lines.append('depthpro_request_latency_seconds_bucket'
                             f'{{le="{ub}"}} {acc}')
            acc += self.lat_buckets[-1]
            lines.append(f'depthpro_request_latency_seconds_bucket{{le="+Inf"}} {acc}')
            lines.append(f"depthpro_request_latency_seconds_sum {self.lat_sum:.6f}")
            lines.append(f"depthpro_request_latency_seconds_count {self.requests}")
        return "\n".join(lines) + "\n"


class _Sessions:
    """Per-client temporal smoothers for streaming video requests.

    A serving batch coalesces UNRELATED concurrent requests, so the
    runner-level stream smoother is rejected outright (see _Batcher): the
    semantic is one EMA state per client stream, applied AFTER the batched
    inference in the request's own thread (the batcher stays stateless;
    clients never blend). A client opts in per request with
    ``?session=<id>&smooth=<alpha>`` (optional ``&tau=``); the filter is
    ``video/temporal.py``'s TemporalSmoother on the host, identical to the
    offline smoothing frame for frame.

    States evict after ``ttl_s`` idle and beyond ``max_sessions``
    (least-recently-used); an evicted session re-seeds on its next frame
    (the frame passes through unsmoothed). Every response that seeded a
    fresh state says so (``smooth_seeded`` json field / ``X-Smooth-Seeded``
    header: a client past its first frame reads it as "my stream lost
    temporal state"), and eviction counts per reason are exported at
    /metrics (``depthpro_smooth_evictions_total``). A session's frames are
    assumed SEQUENTIAL (a video client awaits each response before sending
    the next frame); two in-flight frames of one session serialize on the
    per-session lock in completion order. Changing alpha/tau mid-session
    re-seeds (a new filter contract).
    """

    def __init__(self, ttl_s: float = 300.0, max_sessions: int = 64):
        self.ttl_s = float(ttl_s)
        self.max_sessions = int(max_sessions)
        self._lock = threading.Lock()
        # id -> [smoother, per-session lock, last-used monotonic, params]
        self._entries: dict = {}
        # lifetime eviction counters (reason -> count), under _lock
        self.evictions = {"ttl": 0, "lru": 0}

    def apply(self, session: str, alpha: float, tau: float,
              depth: np.ndarray) -> tuple[np.ndarray, bool]:
        """Smooth ``depth`` through the session's filter. Returns
        ``(depth, seeded)``: ``seeded`` is True when THIS request created a
        fresh state (first frame, post-eviction, or an alpha/tau change):
        the frame passed through unsmoothed."""
        now = time.monotonic()
        with self._lock:
            ent = self._entries.get(session)
            if ent is not None and now - ent[2] > self.ttl_s:
                # expired but not yet purged (purge runs on OTHER
                # traffic/scrapes): resurrecting it would blend stale state
                # into the new frame while claiming seeded=False
                del self._entries[session]
                self.evictions["ttl"] += 1
                ent = None
            seeded = ent is None or ent[3] != (alpha, tau)
            if seeded:
                # host=True: alpha/tau/resolution are client-controlled, and
                # a device update would queue behind the batcher's inference
                ent = [TemporalSmoother(alpha=alpha, tau=tau, host=True),
                       threading.Lock(), now, (alpha, tau)]
                self._entries[session] = ent
            ent[2] = now
            # purge AFTER the insert so the size cap sees the new entry
            # (and never evicts it: it is now the most recently used)
            self._purge(now)
            smoother, session_lock = ent[0], ent[1]
        with session_lock:
            return smoother.update(depth), seeded

    def _purge(self, now: float) -> None:
        """Caller holds self._lock."""
        dead = [k for k, e in self._entries.items() if now - e[2] > self.ttl_s]
        for k in dead:
            del self._entries[k]
        self.evictions["ttl"] += len(dead)
        while len(self._entries) > self.max_sessions:
            lru = min(self._entries, key=lambda k: self._entries[k][2])
            del self._entries[lru]
            self.evictions["lru"] += 1

    def eviction_counts(self) -> dict:
        with self._lock:
            return dict(self.evictions)

    def count(self) -> int:
        with self._lock:
            # purge here too: apply() only runs on smoothing traffic, so an
            # idle server would otherwise hold its states forever; the
            # periodic /metrics scrape is the idle-time eviction driver
            self._purge(time.monotonic())
            return len(self._entries)


def canonicalize(image: np.ndarray, size: int) -> np.ndarray:
    """Host resize of a uint8 (H, W, 3) request to the model's (size, size)."""
    from PIL import Image

    return np.asarray(Image.fromarray(image).resize((size, size), Image.BILINEAR))


def restore(depth: np.ndarray, f_px: float, h: int, w: int, size: int) -> tuple:
    """Canonical (size, size) depth and focal length back at the request's
    (h, w): the map resized bilinearly, the focal length scaled with the
    width (f = 0.5 * w / tan(fov / 2))."""
    from PIL import Image

    depth = Image.fromarray(np.asarray(depth, np.float32))
    return np.asarray(depth.resize((w, h), Image.BILINEAR)), f_px * (w / size)


def encode_png16(depth: np.ndarray) -> tuple[bytes, float, float]:
    """Depth normalized to its [min, max] as a 16-bit grayscale PNG; returns
    (PNG bytes, min, max)."""
    from PIL import Image

    lo, hi = float(depth.min()), float(depth.max())
    normed = ((depth - lo) / max(hi - lo, 1e-9) * 65535).astype(np.uint16)
    buf = io.BytesIO()
    # uint16 arrays map to 16-bit grayscale natively
    Image.fromarray(normed).save(buf, format="PNG")
    return buf.getvalue(), lo, hi


def encode_npz(depth: np.ndarray) -> str:
    """Depth as a compressed npz (array ``depth``), base64 text."""
    buf = io.BytesIO()
    np.savez_compressed(buf, depth=depth)
    return base64.b64encode(buf.getvalue()).decode()


class _Batcher:
    """Coalesce concurrent requests into device batches.

    With ``canonical=True`` (default) every request is resized on the host
    to the model's square working resolution before batching, and the
    depth map is resized back afterwards (focal length rescaled linearly).
    Requests of any resolution then share full device batches of one
    shape. One thread (this batcher's) calls the runner; nothing else of
    the server touches the card."""

    def __init__(self, runner, max_batch: int, max_wait_ms: float,
                 canonical: bool = True, timeout_s: float = 600.0):
        if getattr(runner, "temporal_smooth", 0.0) > 0.0:
            # a serving batch is UNRELATED concurrent requests: the stream
            # smoother would blend one client's depth into another's
            raise ValueError("temporal_smooth runners cannot serve request batches "
                             "(unrelated frames would blend); use depth-pro-smooth-torch "
                             "as a post-pass or ?session=&smooth= per client")
        self.runner = runner
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.canonical = canonical
        self.size = int(runner.cfg.img_size)
        self.timeout_s = timeout_s
        self.metrics = _Metrics()
        self.queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the batcher thread once the queue ahead of the stop is served."""
        self.queue.put(_STOP)
        self._thread.join(timeout)

    def infer(self, image: np.ndarray) -> dict:
        t0 = time.perf_counter()
        try:
            result = self._infer(image)
        except Exception:
            self.metrics.record_request(time.perf_counter() - t0, error=True)
            raise
        self.metrics.record_request(time.perf_counter() - t0, error=False)
        return result

    def _infer(self, image: np.ndarray) -> dict:
        h, w = image.shape[:2]
        rescaled = self.canonical and (h, w) != (self.size, self.size)
        if rescaled:
            image = canonicalize(image, self.size)
        done = threading.Event()
        slot: dict = {}
        self.queue.put((image, slot, done))
        if not done.wait(self.timeout_s):
            raise RuntimeError(f"inference timed out after {self.timeout_s:.0f}s")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        if rescaled:
            slot["depth"], slot["focallength_px"] = restore(
                slot["depth"], slot["focallength_px"], h, w, self.size)
        return slot

    def _loop(self):
        holdover = None
        while True:
            first = holdover if holdover is not None else self.queue.get()
            if first is _STOP:
                return
            holdover = None
            batch = [first]
            shape = first[0].shape
            try:
                while len(batch) < self.max_batch:
                    item = self.queue.get(timeout=self.max_wait)
                    if item is _STOP or item[0].shape != shape:
                        # a device batch must be one resolution; serve the
                        # odd-shaped request (or the stop) after this batch
                        holdover = item
                        break
                    batch.append(item)
            except queue.Empty:
                pass
            images = [b[0] for b in batch]
            self.metrics.record_batch(len(batch))
            try:
                results = list(self.runner.depth_stream(images))
                for (_, slot, done), res in zip(batch, results):
                    slot.update(res)
                    done.set()
                # a dropped frame would misalign the zip AND leave the
                # tail clients waiting forever: fail them explicitly
                for _, slot, done in batch[len(results):]:
                    slot["error"] = "frame dropped by the inference stream"
                    done.set()
            except Exception as exc:  # noqa: BLE001 - every waiting client gets it
                LOGGER.exception("batch of %d failed", len(batch))
                for _, slot, done in batch:
                    slot["error"] = repr(exc)
                    done.set()


def make_handler(batcher: _Batcher, sessions: _Sessions | None = None):
    sessions = sessions if sessions is not None else _Sessions()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                info = {"status": "ok", "device": str(batcher.runner.device)}
                self._send(200, json.dumps(info).encode())
            elif path == "/metrics":
                ev = sessions.eviction_counts()
                body = (batcher.metrics.render(batcher.max_batch)
                        + "# TYPE depthpro_smooth_sessions gauge\n"
                          f"depthpro_smooth_sessions {sessions.count()}\n"
                        + "# TYPE depthpro_smooth_evictions_total counter\n"
                        + "".join(
                            f'depthpro_smooth_evictions_total{{reason="{r}"}}'
                            f" {n}\n" for r, n in sorted(ev.items()))
                        ).encode()
                self._send(200, body, ctype="text/plain; version=0.0.4")
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/v1/depth":
                self._send(404, b'{"error": "not found"}')
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._send(411, b'{"error": "Content-Length required '
                                    b'(chunked bodies are not supported)"}')
                    return
                if length > MAX_BODY:
                    self._send(413, b'{"error": "body exceeds 64 MB"}')
                    return
                data = self.rfile.read(length)  # drain BEFORE any 4xx:
                # responding mid-upload breaks pipelining clients
                q = parse_qs(parsed.query)
                session = q.get("session", [None])[0]
                smooth = q.get("smooth", [None])[0]
                if (session is None) != (smooth is None):
                    self._send(400, b'{"error": "session and smooth must '
                                    b'be given together (a smoother needs '
                                    b'a stream identity)"}')
                    return
                if smooth is not None:
                    try:
                        alpha = float(smooth)
                    except ValueError:
                        alpha = -1.0  # falls into the range reject below
                    if not 0.0 <= alpha < 1.0:
                        self._send(400, b'{"error": "smooth must be in [0, 1)"}')
                        return
                    try:
                        tau = float(q.get("tau", ["0.05"])[0])
                    except ValueError:
                        tau = -1.0
                    # tau <= 0 or NaN makes every pixel fail the static
                    # test: the client would pay for session state while
                    # silently receiving unsmoothed depth
                    if not tau > 0.0:
                        self._send(400, b'{"error": "tau must be a positive number"}')
                        return
                from PIL import Image

                img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                result = batcher.infer(img)
                ret = q.get("return", ["json"])[0]
                depth = result["depth"]
                seeded = None
                if session is not None:
                    # per-stream EMA applied AFTER the shared batch, in this
                    # request's thread: unrelated clients never blend
                    depth, seeded = sessions.apply(session, alpha, tau, depth)
                if ret == "png16":
                    body, lo, hi = encode_png16(depth)
                    # the metric scale travels in headers so the client can
                    # map pixel values back to meters
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Depth-Min", f"{lo:.6f}")
                    self.send_header("X-Depth-Max", f"{hi:.6f}")
                    self.send_header("X-Focallength-Px", f"{result['focallength_px']:.3f}")
                    if seeded is not None:
                        # "1" on any frame past the client's first means
                        # the stream's smoothing state was evicted
                        self.send_header("X-Smooth-Seeded", "1" if seeded else "0")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                payload = {
                    "depth_shape": list(depth.shape),
                    "focallength_px": result["focallength_px"],
                    "depth_min": float(depth.min()),
                    "depth_max": float(depth.max()),
                }
                if seeded is not None:
                    payload["smooth_seeded"] = seeded
                if ret == "npz":
                    payload["npz_base64"] = encode_npz(depth)
                self._send(200, json.dumps(payload).encode())
            except Exception as exc:  # noqa: BLE001 - the client gets a 500
                self._send(500, json.dumps({"error": repr(exc)}).encode())

    return Handler


class DepthServer(ThreadingHTTPServer):
    """The HTTP server with its batcher (``.batcher``, whose ``.runner`` is
    the resident model); ``server_close`` also stops the batcher thread."""

    def __init__(self, address, handler, batcher: _Batcher):
        super().__init__(address, handler)
        self.batcher = batcher

    def server_close(self):
        super().server_close()
        self.batcher.close()


def create_server(host: str = "127.0.0.1", port: int = 8500, runner=None,
                  max_batch: int = 4, max_wait_ms: float = 30.0,
                  warmup_shape: tuple | None = None,
                  parallel: str = "none",
                  speed: str = "exact",
                  exported_path: str | None = None,
                  model: str = "large",
                  quantize: bool = False,
                  session_ttl_s: float = 300.0,
                  max_sessions: int = 64,
                  device="cuda") -> DepthServer:
    """Build the runner (bf16, ``batch_size=max_batch``) on ``device``
    unless one is given, and serve it on ``host:port`` (0: any free port).

    ``warmup_shape=(H, W)`` runs one full batch before the server accepts
    traffic, so that the first request does not pay for the kernels' build
    and the allocator's first growth. ``exported_path`` serves the batches
    from a ``depth-pro-export-torch`` artifact exported at ``--batch_size
    max_batch``: the batcher canonicalises every request to the model's
    size, so every batch has its shape (on the card the artifact currently
    starts and runs slower than eager code: PERF.md, ROADMAP B8).
    ``parallel="dp"|"latency"`` with
    one visible card runs unsharded; over more cards it is not ported yet
    (ROADMAP A item 10)."""
    from ..models.depth_pro import model_preset
    from ..video.runner import DepthVideoRunner

    if parallel not in ("none", "dp", "latency"):
        raise ValueError(f"parallel must be 'none', 'dp' or 'latency', got {parallel!r}")
    if runner is None and parallel in ("dp", "latency"):
        cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
        if cards > 1:
            raise NotImplementedError(
                f"--parallel {parallel} over {cards} CUDA devices is not ported to the "
                "PyTorch package yet: ROADMAP A item 10; make one device visible "
                "(CUDA_VISIBLE_DEVICES) or use --parallel none")
        LOGGER.info("--parallel %s: single device, running unsharded", parallel)
    # the requests arrive decoded, and the runner's process pool decodes
    # only file paths: threads are all the server's runner can use
    runner = runner or DepthVideoRunner(
        cfg=model_preset(model), precision="bf16", batch_size=max_batch, speed=speed,
        exported_path=exported_path, quantize=quantize, decode_pool="thread", device=device)
    # the batcher must coalesce up to the runner's batch or every batch pads
    max_batch = max(max_batch, runner.batch_size)
    if warmup_shape is not None:
        # the batcher canonicalizes every request to (img_size, img_size)
        # on the host, so that is the only shape real traffic runs
        size = int(runner.cfg.img_size)
        if tuple(warmup_shape) != (size, size):
            LOGGER.info("warmup %sx%s canonicalized to %dx%d (the batcher resizes "
                        "all requests)", *warmup_shape, size, size)
        dummy = np.zeros((size, size, 3), np.uint8)
        list(runner.depth_stream([dummy] * max_batch))
    batcher = _Batcher(runner, max_batch=max_batch, max_wait_ms=max_wait_ms)
    sessions = _Sessions(ttl_s=session_ttl_s, max_sessions=max_sessions)
    return DepthServer((host, port), make_handler(batcher, sessions), batcher)


def main(argv=None):
    import argparse

    from ..models.depth_pro import MODEL_PRESETS, SPEED_PRESETS

    ap = argparse.ArgumentParser(description="Depth Pro HTTP serving (PyTorch/CUDA)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--max_wait_ms", type=float, default=30.0)
    ap.add_argument("--warmup", default=None,
                    help="HxW: run one full batch before serving, e.g. 1536x1536 "
                         "(canonicalized to the model's square size)")
    ap.add_argument("--parallel", choices=["none", "dp", "latency"], default="none",
                    help="multi-device modes (not ported yet: ROADMAP A item 10); on one "
                         "visible device they run unsharded")
    ap.add_argument("--speed", choices=sorted(SPEED_PRESETS), default="exact",
                    help="ToMe token-merge approximation tiers "
                         "(balanced=0.25, fast=0.5 merge ratio)")
    ap.add_argument("--exported", default=None,
                    help="an artifact of depth-pro-export-torch, exported with --batch_size "
                         "equal to --max_batch; on the card it currently starts and runs slower than eager code (PERF.md, ROADMAP B8)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weight-only ViT: the three ViTs' block matmul weights held "
                         "as int8 with per-channel scales (a quarter of their fp32 size), "
                         "dequantized to bf16 per matmul")
    ap.add_argument("--model", choices=list(MODEL_PRESETS), default="large",
                    help="model family member (base/small need a trained/distilled "
                         "checkpoint; tiny is the test config)")
    ap.add_argument("--session_ttl", type=float, default=300.0,
                    help="idle seconds before a ?session smoother state is dropped "
                         "(next frame re-seeds)")
    ap.add_argument("--max_sessions", type=int, default=64,
                    help="concurrent ?session smoother states kept (LRU-evicted beyond this)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model: cuda (default) or cpu")
    args = ap.parse_args(argv)
    warm = tuple(int(v) for v in args.warmup.split("x")) if args.warmup else None
    server = create_server(args.host, args.port, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms, warmup_shape=warm,
                           parallel=args.parallel, speed=args.speed,
                           exported_path=args.exported, model=args.model,
                           quantize=args.quantize, session_ttl_s=args.session_ttl,
                           max_sessions=args.max_sessions, device=args.device)
    host, port = server.server_address[:2]
    print(f"serving on {host}:{port} ({server.batcher.runner.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
