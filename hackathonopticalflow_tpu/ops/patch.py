"""Bilinear patch (window) extraction around fractional point positions.

This is the memory-access core of the XLA form of the pyramidal LK tracker:
each measurement point needs a win_size window of the image sampled at a
fractional position (OpenCV samples it with fixed-point bilinear weights).

All pixels of one window share the SAME fractional offset, so instead of
4*K*K scattered gathers per point we take ONE integer-aligned (K+1, K+1)
dynamic slice per point and blend its four integer shifts with shared
bilinear weights — a form that lowers to one gather under vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

def extract_patches(
    img: jnp.ndarray, top_left: jnp.ndarray, size_h: int, size_w: int
) -> jnp.ndarray:
    """Sample (N, size_h, size_w) windows from img at fractional top-left
    positions.

    img:       (H, W) float32 — already padded by the caller so that every
               requested slice (after floor) lies inside; lax.dynamic_slice
               clamps as a safety net.
    top_left:  (N, 2) float32 [x, y] window origins (may be fractional).
    """
    ip = jnp.floor(top_left)
    frac = (top_left - ip).astype(img.dtype)
    ipi = ip.astype(jnp.int32)

    def slice_one(p):
        return lax.dynamic_slice(img, (p[1], p[0]), (size_h + 1, size_w + 1))

    raw = jax.vmap(slice_one)(ipi)  # (N, size_h+1, size_w+1)
    return blend_bilinear(raw, frac, size_h, size_w)


def blend_bilinear(
    raw: jnp.ndarray, frac: jnp.ndarray, size_h: int, size_w: int
) -> jnp.ndarray:
    """Blend the four integer shifts of (N, size_h+1, size_w+1) patches
    with per-patch shared bilinear weights -> (N, size_h, size_w)."""
    ax = frac[:, 0][:, None, None]
    ay = frac[:, 1][:, None, None]
    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay
    return (
        raw[:, :size_h, :size_w] * w00
        + raw[:, :size_h, 1:] * w10
        + raw[:, 1:, :size_w] * w01
        + raw[:, 1:, 1:] * w11
    )


def extract_patches_multi(
    imgs: jnp.ndarray, top_left: jnp.ndarray, size_h: int, size_w: int
) -> jnp.ndarray:
    """Multi-channel variant: sample (N, C, size_h, size_w) windows from a
    (C, H, W) stack at shared fractional positions — ONE dynamic slice per
    point instead of C."""
    c = imgs.shape[0]
    ip = jnp.floor(top_left)
    frac = (top_left - ip).astype(imgs.dtype)
    ipi = ip.astype(jnp.int32)

    def slice_one(p):
        return lax.dynamic_slice(imgs, (0, p[1], p[0]), (c, size_h + 1, size_w + 1))

    raw = jax.vmap(slice_one)(ipi)  # (N, C, size_h+1, size_w+1)
    ax = frac[:, 0][:, None, None, None]
    ay = frac[:, 1][:, None, None, None]
    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay
    return (
        raw[:, :, :size_h, :size_w] * w00
        + raw[:, :, :size_h, 1:] * w10
        + raw[:, :, 1:, :size_w] * w01
        + raw[:, :, 1:, 1:] * w11
    )


def extract_slabs(img: jnp.ndarray, top_left_int: jnp.ndarray, size: int) -> jnp.ndarray:
    """(N, size, size) integer-aligned slabs, one dynamic slice per point.
    top_left_int: (N, 2) int32 [x, y]."""

    def slice_one(p):
        return lax.dynamic_slice(img, (p[1], p[0]), (size, size))

    return jax.vmap(slice_one)(top_left_int)


def select_windows(
    slabs: jnp.ndarray, offsets: jnp.ndarray, win_h: int, win_w: int, margin2: int
) -> jnp.ndarray:
    """Extract (win_h+1, win_w+1) windows from per-point slabs at integer
    offsets in [0, margin2] per axis — via masked STATIC slices (no
    gathers; the slab path of LK's iteration sampling).

    slabs:   (N, S, S) with S >= max(win)+margin2+1
    offsets: (N, 2) int32 [ox, oy], clipped to [0, margin2]
    """
    n, s, _ = slabs.shape
    ox = jnp.clip(offsets[:, 0], 0, margin2)[:, None, None]
    oy = jnp.clip(offsets[:, 1], 0, margin2)[:, None, None]
    rows = jnp.zeros((n, win_h + 1, s), slabs.dtype)
    for k in range(margin2 + 1):
        rows = rows + jnp.where(oy == k, slabs[:, k : k + win_h + 1, :], 0.0)
    out = jnp.zeros((n, win_h + 1, win_w + 1), slabs.dtype)
    for k in range(margin2 + 1):
        out = out + jnp.where(ox == k, rows[:, :, k : k + win_w + 1], 0.0)
    return out
