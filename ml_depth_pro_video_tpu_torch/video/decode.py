"""Host video decoding: mp4/avi -> frame stream.

Copy of ``ml_depth_pro_video_tpu/video/decode.py`` (host code: the port
imports nothing of the JAX package). Frames decode on the host with OpenCV
and stream straight into the batched device runner without touching disk;
``extract_frames`` writes them to a frame directory instead (Pillow).
cv2 and Pillow are imported where they are used.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def video_frames(path: str, start: int = 0, end: int | None = None,
                 stride: int = 1) -> Iterator[tuple[str, np.ndarray]]:
    """Yield ("<stem>_{index:06d}", RGB uint8 frame) from a video file."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    stem = os.path.splitext(os.path.basename(path))[0]
    idx = 0
    try:
        while True:
            if end is not None and idx > end:
                break  # don't decode the rest of the video for nothing
            ok, frame = cap.read()
            if not ok:
                break
            if idx >= start and (idx - start) % stride == 0:
                yield f"{stem}_{idx:06d}", frame[..., ::-1].copy()  # BGR -> RGB
            idx += 1
    finally:
        cap.release()


def video_info(path: str) -> dict:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    try:
        return {
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "fps": float(cap.get(cv2.CAP_PROP_FPS)),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        }
    finally:
        cap.release()


DECODE_COMPLETE_MARKER = ".decode_complete"


# 6 digits keep lexicographic == numeric order past 10k frames (the
# pipeline sorts frame files lexicographically)
def extract_frames(path: str, output_dir: str, pattern: str = "output_{:06d}.png",
                   start: int = 0, end: int | None = None, stride: int = 1) -> list[str]:
    """Decode a video to a frame directory (for the directory-based
    pipeline / resume compatibility)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    # drop any stale marker first: if this (re-)extraction is itself
    # interrupted, a leftover marker from a previous complete decode
    # would validate the now-mixed/truncated frame set on resume
    try:
        os.unlink(os.path.join(output_dir, DECODE_COMPLETE_MARKER))
    except FileNotFoundError:
        pass
    written = []
    for i, (_, frame) in enumerate(video_frames(path, start, end, stride)):
        out = os.path.join(output_dir, pattern.format(i))
        Image.fromarray(frame).save(out)
        written.append(out)
    # decode-complete marker: an interrupted extraction leaves frames on
    # disk that look like a finished set to a later resume run; the
    # marker (written only after the full decode) records the true count
    # so the pipeline can tell complete from truncated
    with open(os.path.join(output_dir, DECODE_COMPLETE_MARKER), "w") as f:
        f.write(f"{len(written)}\n")
    return written
