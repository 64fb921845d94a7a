"""Seeded synthetic video with known motion.

The benchmark, the chip smoke test and the golden tests share these
frames, so every run has the same input without a video corpus. A frame
is a multi-octave value-noise texture (structure from 2 px at 540p to a
sixth of the frame, so LK windows and Farneback's polynomial fits both have
gradients to work with), seen by a camera that approaches a point off the
frame centre (expansion about a focus of expansion, FOE) while it drifts
sideways. Two textured discs cross the scene faster than 40 px per frame
at 1080p — beyond LK's window at level 0, the large-flow case the
pyramid must recover.

Motion is given in pixels at 1080p and scales with the frame height, so
a 270x480 clip shows the same scene as a 1080p one.
"""

from __future__ import annotations

import numpy as np

#: per-frame zoom about the FOE (camera approach)
ZOOM = 1.006
#: FOE as a fraction of (width, height) — off centre
FOE = (0.58, 0.44)
#: background drift per frame in px at 1080p (dx, dy)
DRIFT = (2.5, -1.25)
#: moving discs: (x0, y0) as a fraction of the frame, radius as a fraction
#: of the height, velocity in px per frame at 1080p
DISCS = (
    ((0.25, 0.30), 0.09, (44.0, 17.0)),
    ((0.70, 0.70), 0.07, (-41.0, -22.0)),
)


def _lerp_axis(a: np.ndarray, pos: np.ndarray, axis: int) -> np.ndarray:
    """Linear interpolation of `a` at fractional indices `pos` along axis
    (positions clamped to the array)."""
    n = a.shape[axis]
    pos = np.clip(pos, 0.0, n - 1.0)
    i0 = np.minimum(np.floor(pos).astype(np.int64), n - 2)
    f = (pos - i0).astype(np.float32)
    shape = [1] * a.ndim
    shape[axis] = -1
    f = f.reshape(shape)
    return np.take(a, i0, axis=axis) * (1 - f) + np.take(a, i0 + 1, axis=axis) * f


def _resample(a: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Separable bilinear sampling of a 2-D array on the grid ys x xs."""
    return _lerp_axis(_lerp_axis(a, ys, 0), xs, 1)


def _finest_cell(frame_h: int) -> float:
    """Finest texture octave in px: 2 up to 540 rows, then growing with
    the height, so a 1080p frame looks like a 540p one upsampled (the same
    detail per LK window, as a camera's optics give)."""
    return 2.0 * max(1.0, frame_h / 540.0)


def textured_frame(
    h: int, w: int, seed: int = 0, finest: float | None = None
) -> np.ndarray:
    """(h, w) float32 texture in [0, 255] with octaves from `finest` px
    (default: _finest_cell(h)) to a sixth of the frame."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), np.float32)
    cell = _finest_cell(h) if finest is None else finest
    while cell <= max(h, w) / 6:
        gh, gw = int(h / cell) + 2, int(w / cell) + 2
        grid = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.arange(h, dtype=np.float32) / cell
        xs = np.arange(w, dtype=np.float32) / cell
        out += _resample(grid, ys, xs) * np.float32(cell**0.5)
        cell *= 2.0
    lo, hi = np.percentile(out, [1, 99])
    return np.clip((out - lo) / (hi - lo) * 215.0 + 20.0, 0.0, 255.0)


def seeded_clip(n_frames: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(n_frames, h, w) uint8 gray clip with the motion described above."""
    s = h / 1080.0
    m = int(0.25 * max(h, w)) + 8  # world margin around the first view
    world = textured_frame(h + 2 * m, w + 2 * m, seed, finest=_finest_cell(h))
    # disc textures are frame-sized so their contrast statistics match the
    # background's, and their edges are soft: a sharper disc would draw
    # every Shi-Tomasi corner onto points that move too fast to track
    discs = [textured_frame(h, w, seed + 1 + i) for i in range(len(DISCS))]
    ramp = _finest_cell(h)  # disc edges soften over the finest octave
    fx, fy = FOE[0] * w, FOE[1] * h
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    frames = np.empty((n_frames, h, w), np.uint8)
    for t in range(n_frames):
        z = ZOOM**t
        # world coordinates seen at each pixel: zoom about the FOE, drift
        xs = fx + (np.arange(w, dtype=np.float32) - fx) / z - t * DRIFT[0] * s + m
        ys = fy + (np.arange(h, dtype=np.float32) - fy) / z - t * DRIFT[1] * s + m
        img = _resample(world, ys, xs)
        for (c0, r, v), tex in zip(DISCS, discs):
            rad = int(r * h)
            cx = (c0[0] * w + t * v[0] * s) % w
            cy = (c0[1] * h + t * v[1] * s) % h
            dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            alpha = np.clip((rad - dist) / ramp + 0.5, 0.0, 1.0)
            dy = np.clip(yy - cy + h / 2, 0, h - 1)
            dx = np.clip(xx - cx + w / 2, 0, w - 1)
            img = img + alpha * (_resample(tex, dy[:, 0], dx[0]) - img)
        frames[t] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return frames


def seeded_pair(h: int, w: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Two consecutive uint8 gray frames of seeded_clip."""
    a, b = seeded_clip(2, h, w, seed)
    return a, b


def seeded_bgr_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8 colour frame: three independent textures."""
    return np.stack(
        [textured_frame(h, w, seed + c) for c in range(3)], axis=-1
    ).round().astype(np.uint8)
