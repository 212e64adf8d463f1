"""Teacher -> student distillation for the Depth Pro model family.

Twin of ``ml_depth_pro_video_tpu/train/distill.py`` on the port's runner and
``fit``. The large teacher runs over unlabeled frames once and its metric
depth is cached as ordinary (image, depth) pairs (with the teacher's focal
length, so ``train/data.py`` trains on canonical-unit targets); the student
(``models/depth_pro.py::model_preset`` ``base`` / ``small``) is then
fine-tuned on the cache with ``fit()``.

Two-phase by design: the label cache is resumable (a killed labeling run
continues where it stopped; ``fit`` resumes from its own checkpoints),
inspectable (plain PNG + npz on disk), and reusable across student configs
and hyperparameter sweeps without running the teacher again.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

log = logging.getLogger(__name__)


def distill_labels(
    frames: str,
    labels_dir: str,
    teacher_runner=None,
    batch_size: int = 8,
    precision: str = "bf16",
    downscale_factor: float = 1.0,
    pattern: str = "*.png",
    start: int = 0,
    end: int | None = None,
    stride: int = 1,
    device="cuda",
) -> int:
    """Teacher labeling pass: frames (directory or video file) -> a
    ``DepthDataset``-layout directory of ``<stem>.png`` +
    ``<stem>_depth.npz`` pairs. Already-labeled stems are skipped, so
    an interrupted pass resumes for free. Returns pairs written. Without
    ``teacher_runner`` a ``large`` runner is built on ``device``.

    The cached image is exactly what the teacher saw (after any
    ``downscale_factor``), so the student trains against pixel-aligned
    targets.
    """
    from ..video.runner import DepthVideoRunner

    if teacher_runner is None:
        teacher_runner = DepthVideoRunner(precision=precision,
                                          batch_size=batch_size,
                                          downscale_factor=downscale_factor,
                                          device=device)
    os.makedirs(labels_dir, exist_ok=True)

    def done(name: str) -> bool:
        return os.path.exists(os.path.join(labels_dir, name + "_depth.npz"))

    if os.path.isdir(frames):
        paths = sorted(glob.glob(os.path.join(frames, pattern)))
        paths = paths[start:None if end is None else end + 1:stride]
        if not paths:
            raise FileNotFoundError(f"no {pattern} frames under {frames}")
        todo = [p for p in paths
                if not done(os.path.splitext(os.path.basename(p))[0])]
        if len(todo) < len(paths):
            log.info("resuming labeling: %d/%d frames already done",
                     len(paths) - len(todo), len(paths))
        n_todo = len(todo)
        # path items: the result carries its own key (an unreadable
        # frame skips without desyncing any name bookkeeping)
        results = ((os.path.splitext(os.path.basename(r["key"]))[0], r)
                   for r in teacher_runner.depth_stream(todo))
    else:
        from collections import deque

        from ..video.decode import video_frames

        # lazy: frames decode in the runner's prefetch thread, O(1) in
        # RAM for arbitrarily long videos. Names ride a side queue —
        # appended at decode time, popped at result time; ndarray items
        # cannot be "unreadable", so the order matches exactly.
        names_q: deque = deque()
        n_todo = None

        def gen():
            for k, f in video_frames(frames, start=start, end=end,
                                     stride=stride):
                if done(k):
                    continue
                names_q.append(k)
                yield f

        results = ((names_q.popleft(), r)
                   for r in teacher_runner.depth_stream(gen()))

    from PIL import Image

    written = 0
    for name, result in results:
        img_path = os.path.join(labels_dir, name + ".png")
        Image.fromarray(result["image"]).save(img_path)
        # write depth last and atomically: the pair is only considered
        # done when the npz exists, so a kill mid-write cannot leave a
        # half-labeled pair that resume would skip
        npz = os.path.join(labels_dir, name + "_depth.npz")
        np.savez_compressed(npz + ".tmp.npz",
                            depth=result["depth"].astype(np.float32),
                            focallength_px=result["focallength_px"])
        os.replace(npz + ".tmp.npz", npz)
        written += 1
        if written % 25 == 0:
            tot = f"/{n_todo}" if n_todo else ""
            log.info("labeled %d%s frames", written, tot)
    return written


def distill(
    frames: str,
    labels_dir: str,
    student: str = "small",
    teacher_runner=None,
    student_cfg=None,
    teacher_batch_size: int = 8,
    downscale_factor: float = 1.0,
    pattern: str = "*.png",
    device="cuda",
    **fit_kwargs,
):
    """Label with the teacher, then ``fit()`` the student on the cache, both
    on ``device``.

    ``student`` names a `model_preset` (or pass ``student_cfg``);
    ``fit_kwargs`` flow to `train.loop.fit` (batch_size, epochs, lr,
    tp/pp, checkpoint_dir, holdout, ...). Returns the final TrainState.
    """
    from ..models.depth_pro import model_preset
    from .loop import fit

    distill_labels(frames, labels_dir, teacher_runner=teacher_runner,
                   batch_size=teacher_batch_size,
                   downscale_factor=downscale_factor, pattern=pattern, device=device)
    cfg = student_cfg if student_cfg is not None else model_preset(student)
    return fit(labels_dir, cfg, device=device, **fit_kwargs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Distill Depth Pro large into a smaller family member")
    ap.add_argument("--frames", required=True,
                    help="unlabeled frames directory or video file")
    ap.add_argument("--labels_dir", required=True,
                    help="teacher label cache (resumable, reusable)")
    ap.add_argument("--student", default="small",
                    choices=["base", "small", "tiny"])
    ap.add_argument("--teacher_batch_size", type=int, default=8)
    ap.add_argument("--downscale_factor", type=float, default=1.0)
    ap.add_argument("--pattern", default="*.png")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup_steps", type=int, default=100)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--holdout", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the teacher and the student: cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="miniature fp32 teacher and student (smoke tests)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    teacher = None
    if args.tiny:
        from ..models.depth_pro import tiny_config
        from ..video.runner import DepthVideoRunner

        teacher = DepthVideoRunner(cfg=tiny_config(), precision="fp32",
                                   batch_size=args.teacher_batch_size,
                                   downscale_factor=args.downscale_factor, device=args.device)
    distill(args.frames, args.labels_dir, student="tiny" if args.tiny else args.student,
            teacher_runner=teacher, teacher_batch_size=args.teacher_batch_size,
            downscale_factor=args.downscale_factor, pattern=args.pattern,
            batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
            warmup_steps=args.warmup_steps, tp=args.tp, pp=args.pp,
            checkpoint_dir=args.checkpoint_dir, save_every=args.save_every,
            holdout=args.holdout, device=args.device)


if __name__ == "__main__":  # pragma: no cover
    main()
