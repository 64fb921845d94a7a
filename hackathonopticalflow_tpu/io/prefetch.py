"""Host->device frame prefetch pipeline.

The reference's loop decodes a frame, converts it, computes, then shows it
— fully serial (pathfinder_viewer.py:270-358). Here decode + gray
conversion run in a background thread (cv2 decode or a .npy/.npz frame
stack, + the native C++ bgr2gray when available), frames are staged into
a bounded queue, and device_put overlaps with compute.

batch_frames() groups frames into one device-resident chunk for
scan-based processing.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

import jax
import jax.numpy as jnp

from .video import VideoReader, to_gray


class FramePrefetcher:
    """Background decode -> gray -> queue; iterate device arrays."""

    def __init__(
        self,
        path: str,
        start_frame: int = 0,
        max_frames: int | None = None,
        depth: int = 4,
        to_device: bool = True,
        dtype=jnp.float32,
        keep_bgr: bool = False,
    ):
        self.reader = VideoReader(path)
        if start_frame:
            self.reader.seek(start_frame)
        self.max_frames = max_frames
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.to_device = to_device
        self.dtype = dtype
        self.keep_bgr = keep_bgr  # yield (bgr, gray) pairs for rendering
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        n = 0
        while self.max_frames is None or n < self.max_frames:
            frame = self.reader.read()
            if frame is None:
                break
            g = to_gray(frame)
            self.q.put((frame, g) if self.keep_bgr else g)
            n += 1
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if self.keep_bgr:
                yield item
            elif self.to_device:
                yield jnp.asarray(item, self.dtype)
            else:
                yield item


def batch_frames(
    path: str, start: int, count: int, resize_hw: tuple[int, int] | None = None
) -> jnp.ndarray:
    """Decode `count` consecutive gray frames into one device-resident
    (count, H, W) uint8 array (single transfer)."""
    out = []
    with VideoReader(path) as vr:
        if start:
            vr.seek(start)
        for _ in range(count):
            frame = vr.read()
            if frame is None:
                break
            g = to_gray(frame)
            if resize_hw is not None:
                import cv2

                g = cv2.resize(g, (resize_hw[1], resize_hw[0]), interpolation=cv2.INTER_AREA)
            out.append(g)
    return jax.device_put(jnp.asarray(np.stack(out)))
