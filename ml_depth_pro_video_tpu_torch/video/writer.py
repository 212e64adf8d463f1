"""Streaming host video encoder.

Copy of ``ml_depth_pro_video_tpu/video/writer.py`` (host code: the port
imports nothing of the JAX package). ``VideoSink`` appends frames as they
arrive, so the depth runner's output stream pipes straight into the
encoder and a video of any length encodes in O(1) host memory.

Encoder selection: cv2 (mp4v) when it opens, else a streaming imageio
writer, with a warning. Both are imported where they are used.
"""

from __future__ import annotations

import logging
import os

import numpy as np

LOGGER = logging.getLogger(__name__)


class VideoSink:
    """Append-as-you-go video writer for (H, W, 3) uint8 RGB frames.

    The frame size is fixed by the first ``append``; later frames must
    match (a mismatch raises — silently letting cv2 drop them would
    truncate the video with no error). Usable as a context manager;
    ``close()`` is idempotent.
    """

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = float(fps) if fps and fps > 0 else 30.0
        self.frames_written = 0
        self._writer = None
        self._backend = None
        self._shape = None

    def _open(self, h: int, w: int) -> None:
        try:
            import cv2

            vw = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 self.fps, (w, h))
            if not vw.isOpened():
                raise RuntimeError("cv2.VideoWriter failed to open")
            self._writer, self._backend = vw, "cv2"
            return
        except Exception as exc:  # noqa: BLE001 - fall back, but say why
            LOGGER.warning("cv2 video encode unavailable (%s); "
                           "falling back to imageio", exc)
            if os.path.exists(self.path):
                try:
                    os.remove(self.path)
                except OSError:
                    pass
        import imageio

        self._writer = imageio.get_writer(self.path, fps=self.fps)
        self._backend = "imageio"

    @property
    def backend(self) -> str | None:
        """The encoder writing the file, ``"cv2"`` or ``"imageio"`` (None
        before the first frame)."""
        return self._backend

    def append(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) RGB frame, got {frame.shape}")
        if frame.dtype != np.uint8:
            frame = np.clip(frame, 0, 255).astype(np.uint8)
        if self._writer is None:
            self._shape = frame.shape[:2]
            self._open(*self._shape)
        elif frame.shape[:2] != self._shape:
            raise ValueError(f"frame size {frame.shape[:2]} != first frame "
                             f"{self._shape} (video frame size is fixed)")
        if self._backend == "cv2":
            self._writer.write(frame[..., ::-1])  # RGB -> BGR
        else:
            self._writer.append_data(frame)
        self.frames_written += 1

    def close(self) -> None:
        if self._writer is not None:
            if self._backend == "cv2":
                self._writer.release()
            else:
                self._writer.close()
            self._writer = None

    def __enter__(self) -> "VideoSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
