"""Host-side training data pipeline.

Twin of ``ml_depth_pro_video_tpu/train/data.py``. No third-party input
stack: a directory dataset of (image, depth) pairs with a background
prefetch thread, an ordered decode pool, deterministic shuffling, and an
upload to one device (pinned host memory, non-blocking copy) in place of
the JAX package's DP sharding; across ranks each rank decodes only its rows
of every global batch (``local_rows``). Batches are ``torch`` tensors; their
values equal the JAX package's arrays bit for bit.

Expected layout: ``<root>/*.png|jpg`` images with matching
``<root>/<stem>_depth.npy`` (or ``.npz`` with a ``depth`` array).
"""

from __future__ import annotations

import glob
import os
import queue
import threading

import numpy as np
import torch

class DepthDataset:
    def __init__(self, root: str, image_size: int, seed: int = 0):
        self.image_size = image_size
        self.pairs = []
        for img in sorted(glob.glob(os.path.join(root, "*.png")) + glob.glob(os.path.join(root, "*.jpg"))):
            stem = os.path.splitext(img)[0]
            for ext in ("_depth.npy", "_depth.npz"):
                if os.path.exists(stem + ext):
                    self.pairs.append((img, stem + ext))
                    break
        if not self.pairs:
            raise FileNotFoundError(f"no (image, depth) pairs under {root}")
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.pairs)

    def _load(self, idx: int):
        from PIL import Image

        img_path, depth_path = self.pairs[idx]
        s = self.image_size
        img = Image.open(img_path).convert("RGB")
        w_orig = img.size[0]
        img = img.resize((s, s), Image.BILINEAR)
        x = np.asarray(img, np.float32) / 127.5 - 1.0
        f_px = None
        if depth_path.endswith(".npz"):
            with np.load(depth_path) as f:
                d = f["depth"]
                if "focallength_px" in f.files:
                    f_px = float(f["focallength_px"])
        else:
            d = np.load(depth_path)
        # Validity-aware resize: bilinear on raw depth bleeds zero-valued
        # hole pixels into neighbors (a 2 m pixel next to a hole becomes
        # e.g. 0.5 m — positive, so it would PASS the silog (target > 0)
        # mask with a wildly wrong log). Resize the validity mask along
        # with the depth and re-invalidate every hole-touched pixel.
        d = np.asarray(d, np.float32)
        valid = (d > 0).astype(np.float32)
        d = np.asarray(Image.fromarray(d).resize((s, s), Image.BILINEAR))
        v = np.asarray(Image.fromarray(valid).resize((s, s), Image.BILINEAR))
        d = np.where(v >= 0.999, d, 0.0)
        if f_px is not None and f_px > 0:
            # metric -> CANONICAL-unit depth: the loss supervises
            # 1/canonical (train/step.py::loss_fn) but inference maps
            # canonical to metric through the focal factor,
            # depth = (f_px/w)/canonical (models/depth_pro.py infer_fn)
            # — training on raw metric depth would bake a systematic
            # f_px/w scale error into the model (and mixed-focal
            # datasets would get mutually inconsistent supervision).
            # The ratio uses the ORIGINAL image width: f_px is expressed
            # at that scale, and w/f_px (= 2·tan(hfov/2)) is invariant
            # under the square training resize. The distillation
            # labeler caches focallength_px per pair (train/distill.py)
            # exactly for this; pairs without it (.npy, plain npz)
            # implicitly assume f_px == w (~53° horizontal FOV).
            d = d * (w_orig / f_px)
        return x, d

    def batches(self, batch_size: int, epochs: int = 1, device=None,
                prefetch: int = 2, drop_remainder: bool = True, skip: int = 0,
                local_rows=None, assemble=None, zero_substitute: bool = False,
                decode_workers: int | None = None):
        """Yield (images (B,S,S,3), depth (B,S,S)) fp32 tensors, on
        ``device`` when given (copied from pinned host memory without
        blocking the host), else on the CPU.

        ``skip`` advances past the first N batches WITHOUT loading them
        (deterministic stream replay for checkpoint resume: the shuffle
        permutations are consumed, the images are not decoded).

        Pairs decode on a bounded order-preserving thread pool
        (``decode_workers``, default min(8, cores)).

        ``zero_substitute``: replace an unreadable pair IN PLACE with a
        zero-depth sample (exactly zero loss/grad under the silog mask)
        instead of skipping it. Use wherever batch composition must be
        deterministic across runs; validation does.

        Across ranks (``local_rows`` + ``assemble``): every rank runs the SAME
        seeded permutation stream but decodes only the global batch rows in
        ``local_rows`` (``parallel/multihost.local_rows``), and the stacked
        local slabs are passed through ``assemble`` before the upload (the
        training loop keeps each rank's rows: the identity). Row alignment
        across ranks is load-bearing, so unreadable pairs and rows past a
        short batch's end are always zero-depth rows there: dropping one would
        shift every later row on one rank only. Assumes all ranks see the
        same file listing (``self.pairs`` is globbed and sorted)."""
        if (local_rows is None) != (assemble is None):
            raise ValueError("local_rows and assemble must be given together")
        if device is not None:
            device = torch.device(device)
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = object()
        # set when the consumer abandons the generator (exception in the
        # train step, early break): a producer blocked on q.put would
        # otherwise hold its decoded batches for the life of the process
        abandoned = threading.Event()
        if decode_workers is None:
            decode_workers = max(1, min(8, os.cpu_count() or 1))

        def put(item) -> bool:
            """q.put that gives up when the consumer is gone."""
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def zero_pair():
            s = self.image_size
            return (np.zeros((s, s, 3), np.float32),
                    np.zeros((s, s), np.float32))

        def load_isolated(j):
            """(x, d) or None — one corrupt pair must not kill the
            whole stream (thread-pool safe; logging is)."""
            import logging

            try:
                return self._load(j)
            except Exception as exc:  # noqa: BLE001
                logging.getLogger(__name__).warning(
                    "unreadable pair %s: %s", self.pairs[j][0], exc)
                return None

        def stacked(data):
            xs = torch.from_numpy(np.stack([d[0] for d in data]))
            ds = torch.from_numpy(np.stack([d[1] for d in data]))
            if device is not None and device.type == "cuda":
                # pinned here, in the producer, so the consumer's copy does
                # not block the host
                xs, ds = xs.pin_memory(), ds.pin_memory()
            return xs, ds

        def load_local(sel, ex):
            """This rank's rows of the global batch, in global-row order;
            unreadable and pad rows carry a zero depth target (exactly zero
            loss and gradient under the silog mask)."""
            idxs = [sel[min(r, len(sel) - 1)] for r in local_rows]
            loaded = list(ex.map(load_isolated, idxs))
            return [zero_pair() if entry is None or r >= len(sel) else entry
                    for r, entry in zip(local_rows, loaded)]

        def producer():
            import logging
            from concurrent.futures import ThreadPoolExecutor

            n_out = 0
            try:
                with ThreadPoolExecutor(decode_workers) as ex:
                    for _ in range(epochs):
                        order = self.rng.permutation(len(self.pairs))
                        for i in range(0, len(order), batch_size):
                            if abandoned.is_set():
                                return
                            sel = order[i : i + batch_size]
                            if drop_remainder and len(sel) < batch_size:
                                continue
                            n_out += 1
                            if n_out <= skip:
                                continue  # resume replay: never decoded
                            if local_rows is not None:
                                data = load_local(sel, ex)
                                if not put(stacked(data)):
                                    return
                                continue
                            loaded = list(ex.map(load_isolated, sel))
                            if zero_substitute:
                                # deterministic batch composition (see
                                # docstring): failures become zero-loss
                                # rows, never dropped
                                data = [zero_pair() if e is None else e
                                        for e in loaded]
                            else:
                                data = [e for e in loaded if e is not None]
                            if not data:
                                # every pair unreadable: dropping desyncs
                                # the decode-free resume skip by one
                                # batch — say so
                                logging.getLogger(__name__).warning(
                                    "entire batch unreadable — dropped; "
                                    "checkpoint-resume replay will be "
                                    "offset by one batch")
                                n_out -= 1
                                continue
                            # pad short batches to full size instead of
                            # dropping: every counted permutation batch
                            # then yields exactly one step, keeping the
                            # decode-free `skip` aligned with state.step.
                            # Pad samples reuse the last image but carry an
                            # ALL-ZERO depth target — the silog mask
                            # (`train/step.py::silog_loss`, target > 0
                            # with a global valid-pixel count) gives them
                            # exactly zero loss and gradient, so
                            # duplicates get no extra weight.
                            if drop_remainder:
                                while len(data) < batch_size:
                                    data.append((data[-1][0],
                                                 np.zeros_like(data[-1][1])))
                            if not put(stacked(data)):
                                return
            finally:
                put(stop)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    return
                xs, ds = item
                if assemble is not None:
                    xs, ds = assemble(xs), assemble(ds)
                if device is not None:
                    xs = xs.to(device, non_blocking=True)
                    ds = ds.to(device, non_blocking=True)
                yield xs, ds
        finally:
            # consumer gone (normal exhaustion, break, or a raising
            # train step): unblock the producer so it exits instead of
            # holding ~prefetch decoded batches forever
            abandoned.set()
