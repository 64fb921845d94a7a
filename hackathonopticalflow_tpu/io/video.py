"""Host-side video decode.

Frames are decoded on the host into numpy buffers and transferred to the
device by the prefetch pipeline (io/prefetch.py). This module mirrors the
reference's access patterns: sequential playback (pathfinder_viewer.py:274)
and random-access frame grabs by index (Operations.py:8-33,
CAP_PROP_POS_FRAMES seeks).

Two sources: video files through OpenCV, when it is installed, and raw
frame stacks saved with numpy — a `.npy` array, or the `frames` array of
a `.npz` (an optional scalar `fps` beside it) — of shape (T, H, W) gray
or (T, H, W, 3) BGR uint8. The frame stacks need no OpenCV.
"""

from __future__ import annotations

import pathlib
from typing import Iterator, Sequence

import numpy as np

try:  # pragma: no cover - availability depends on the environment
    import cv2

    HAVE_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    HAVE_CV2 = False

#: frame rate reported for frame stacks that do not record one
DEFAULT_FPS = 25.0


def to_gray(frame: np.ndarray) -> np.ndarray:
    """uint8 gray frame: 2-D frames pass through, BGR goes through the
    native converter (io/native) or OpenCV (same rounding)."""
    if frame.ndim == 2:
        return frame
    from . import native_lib

    if native_lib.available():
        return native_lib.bgr2gray_u8(frame)
    return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)


class _StackCapture:
    """cv2.VideoCapture-shaped reader over an in-memory frame stack."""

    def __init__(self, path: str):
        if path.endswith(".npz"):
            with np.load(path) as z:
                self.frames = np.asarray(z["frames"])
                self.fps = float(z["fps"]) if "fps" in z else DEFAULT_FPS
        else:
            self.frames = np.load(path, mmap_mode="r")
            self.fps = DEFAULT_FPS
        if self.frames.ndim not in (3, 4) or self.frames.dtype != np.uint8:
            raise ValueError(
                f"{path}: expected a (T, H, W[, 3]) uint8 frame stack, got "
                f"{self.frames.shape} {self.frames.dtype}"
            )
        self.pos = 0

    def read(self) -> np.ndarray | None:
        if self.pos >= len(self.frames):
            return None
        frame = np.array(self.frames[self.pos])
        self.pos += 1
        return frame


class VideoReader:
    """Sequential/seekable frame reader over a video file (cv2) or a
    .npy/.npz frame stack."""

    def __init__(self, path: str | pathlib.Path):
        self.path = str(path)
        self.stack = None
        self.cap = None
        if self.path.endswith((".npy", ".npz")):
            if not pathlib.Path(self.path).exists():
                raise FileNotFoundError(self.path)
            self.stack = _StackCapture(self.path)
            t, h, w = self.stack.frames.shape[:3]
            self.length, self.fps, self.width, self.height = t, self.stack.fps, w, h
            return
        if not HAVE_CV2:
            raise RuntimeError(
                "cv2 is required to decode video files; .npy/.npz frame "
                "stacks need no decoder"
            )
        self.cap = cv2.VideoCapture(self.path)
        if not self.cap.isOpened():
            raise FileNotFoundError(self.path)
        self.length = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def seek(self, frame_idx: int) -> None:
        if self.stack is not None:
            self.stack.pos = frame_idx
        else:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)

    def read(self) -> np.ndarray | None:
        if self.stack is not None:
            return self.stack.read()
        ok, frame = self.cap.read()
        return frame if ok else None

    def read_gray(self) -> np.ndarray | None:
        frame = self.read()
        if frame is None:
            return None
        return to_gray(frame)

    def frames(self, start: int = 0, count: int | None = None) -> Iterator[np.ndarray]:
        if start:
            self.seek(start)
        n = 0
        while count is None or n < count:
            frame = self.read()
            if frame is None:
                return
            yield frame
            n += 1

    def release(self) -> None:
        if self.cap is not None:
            self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def read_frames(
    path: str | pathlib.Path, indices: Sequence[int], gray: bool = False
) -> list[np.ndarray]:
    """Random-access frame grab by index list (Operations.py:8-33 analog)."""
    out = []
    with VideoReader(path) as vr:
        for idx in indices:
            vr.seek(idx)
            frame = vr.read_gray() if gray else vr.read()
            if frame is None:
                raise IOError(f"lost frame {idx} of {path}")
            out.append(frame)
    return out


def read_gray_pair(path: str | pathlib.Path, idx: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic consecutive gray frame pair (analog of the
    reference's frame-pair development workflow)."""
    a, b = read_frames(path, [idx, idx + 1], gray=True)
    return a, b
