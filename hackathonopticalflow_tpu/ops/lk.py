"""Pyramidal iterative Lucas-Kanade sparse optical flow.

A from-scratch XLA implementation numerically faithful to
cv2.calcOpticalFlowPyrLK as called by the reference
(pathfinder_viewer.py:154-158: win 45x45, maxLevel 2, <=10 iterations,
eps 0.03; SparseOF.py:6-8: win 15x15), including:

- pyrDown pyramid (5-tap, BORDER_REFLECT_101), ceil-halved level sizes;
- Scharr (3,10,3)/32 template gradients per level, zero border padding;
- image levels padded with BORDER_REFLECT_101 (window sampling beyond the
  frame reads reflected pixels, as buildOpticalFlowPyramid arranges);
- per-point 2x2 structure tensor from the template window, with OpenCV's
  fixed-point scale on the spectral checks (A_cv = A_true * 2^10/2^20,
  minEig < 1e-4, det < FLT_EPSILON);
- the exact iteration schedule: Gauss-Newton step
  delta = ((A12 b2 - A22 b1)/D, (A12 b1 - A11 b2)/D), convergence on
  |delta|^2 <= eps^2, and the oscillation damper
  (|delta + prev_delta| < 0.01 in both axes -> back off half a step);
- coarse-to-fine x2 upscaling of the estimate, with invalid points
  passing their current estimate through unchanged (OpenCV `continue`).

The XLA form processes points as one dense (N, win, win) batch per
pyramid level; window sampling uses the shared-fractional-offset bilinear
trick in ops/patch.py (one (win+1)^2 dynamic slice + 4 shifted blends per
point). Per-point control flow (convergence, out-of-bounds, degenerate
tensors) is carried as masks through a fori_loop. On CUDA each level's
loop runs instead as one Triton kernel with a per-point early exit
(ops/lk_triton.py). Everything is jittable with static shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..core.config import LKParams
from .deriv import scharr_deriv
from .patch import (
    blend_bilinear,
    extract_patches,
    extract_patches_multi,
    extract_slabs,
    select_windows,
)
from .lk_triton import level_lk_triton
from .pyramid import build_pyramid

_FLT_EPSILON = 1.1920929e-07
# OpenCV accumulates with W_BITS=14 fixed point and FLT_SCALE = 2^-20;
# its A and b come out as (true value) * 32*32 / 2^20 = (true value)/1024.
_CV_SCALE = 1.0 / 1024.0


class LKResult(NamedTuple):
    next_pts: jnp.ndarray  # (N, 2) float32
    status: jnp.ndarray  # (N,) bool — False where tracking failed at level 0
    err: jnp.ndarray  # (N,) float32 — mean |window residual| at level 0


class PreparedFrame(NamedTuple):
    """Per-frame precomputation shared by every LK call that touches the
    frame: quantized pyramid levels and Scharr derivatives, already
    border-padded for window sampling. In video scans each frame serves
    as both 'previous' and 'current' of consecutive pairs — preparing it
    once halves the pyramid/derivative/pad work (see lk_grid_flow_video)."""

    img_p: tuple  # per level: (H+2p, W+2p) reflect-padded image
    dix_p: tuple  # per level: zero-padded d/dx
    diy_p: tuple  # per level: zero-padded d/dy


def _frame_pad(params: LKParams) -> int:
    """Window-sampling border pad: a window whose top-left passes the oob
    gate (floor >= -win) still lies inside the padded plane."""
    win_w, win_h = params.win_size
    return max(win_w, win_h) + 2


def prepare_frame(img: jnp.ndarray, params: LKParams) -> PreparedFrame:
    pad = _frame_pad(params)
    pyr = build_pyramid(img.astype(jnp.float32), params.max_level, quantize_u8=True)
    imgs, dxs, dys = [], [], []
    for lv in pyr:
        dx, dy = scharr_deriv(lv)
        imgs.append(jnp.pad(lv, pad, mode="reflect"))
        dxs.append(jnp.pad(dx, pad, mode="constant"))
        dys.append(jnp.pad(dy, pad, mode="constant"))
    return PreparedFrame(img_p=tuple(imgs), dix_p=tuple(dxs), diy_p=tuple(dys))


def _level_lk(
    prev_prep: PreparedFrame,
    next_prep: PreparedFrame,
    pts: jnp.ndarray,
    next_center: jnp.ndarray,
    status: jnp.ndarray,
    level: int,
    params: LKParams,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One pyramid level: (next_center, status, err) after the level's
    Gauss-Newton loop. On CUDA the exact loop runs as the Triton kernel
    (ops/lk_triton.py); every other backend, and the slab path, runs the
    XLA form below, which is the reference the kernel is tested against."""
    win_w, win_h = params.win_size
    halfwin = jnp.array([(win_w - 1) * 0.5, (win_h - 1) * 0.5], jnp.float32)
    args = (
        prev_prep.img_p[level],
        prev_prep.dix_p[level],
        prev_prep.diy_p[level],
        next_prep.img_p[level],
        pts,
        next_center - halfwin,
        status,
    )
    xla = functools.partial(_level_lk_xla, level=level, params=params)
    if params.slab_margin is None:
        kernel = functools.partial(
            level_lk_triton,
            level=level,
            win_size=params.win_size,
            pad=_frame_pad(params),
            max_iters=params.max_iters,
            eps=params.eps,
            min_eig_threshold=params.min_eig_threshold,
            compute_err=params.compute_err,
        )
        next_tl, status, err = lax.platform_dependent(
            *args, cuda=kernel, default=xla
        )
    else:
        next_tl, status, err = xla(*args)
    return next_tl + halfwin, status, err


def _level_lk_xla(
    img_prev_p: jnp.ndarray,
    dix_p: jnp.ndarray,
    diy_p: jnp.ndarray,
    img_next_p: jnp.ndarray,
    pts: jnp.ndarray,
    next_tl0: jnp.ndarray,
    status: jnp.ndarray,
    *,
    level: int,
    params: LKParams,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """XLA form of one level over (N, win, win) window batches. Same
    signature and results as ops/lk_triton.level_lk_triton: (next_tl,
    status, err), with err zero unless level 0 and params.compute_err."""
    win_w, win_h = params.win_size
    halfwin = jnp.array([(win_w - 1) * 0.5, (win_h - 1) * 0.5], jnp.float32)
    pad = _frame_pad(params)
    eps2 = jnp.float32(max(params.eps, 0.0) ** 2)
    h = img_prev_p.shape[0] - 2 * pad
    w = img_prev_p.shape[1] - 2 * pad
    scale = jnp.float32(1.0 / (1 << level))
    tmpl_tl = pts * scale - halfwin  # (N, 2) top-left of template window
    it = jnp.floor(tmpl_tl)
    oob_tmpl = (
        (it[:, 0] < -win_w) | (it[:, 0] >= w) | (it[:, 1] < -win_h) | (it[:, 1] >= h)
    )

    pad_off = jnp.float32(pad)

    def _fix(x):
        # OpenCV samples windows in W_BITS fixed point: values land on a
        # 1/32-intensity grid (CV_DESCALE by W_BITS1-5). Reproduce that
        # quantization for parity on ill-conditioned windows.
        return jnp.floor(x * 32.0 + 0.5) * (1.0 / 32.0)

    tmpl = _fix(
        extract_patches_multi(
            jnp.stack([img_prev_p, dix_p, diy_p]), tmpl_tl + pad_off, win_h, win_w
        )
    )
    iw, ixw, iyw = tmpl[:, 0], tmpl[:, 1], tmpl[:, 2]

    a11 = jnp.sum(ixw * ixw, axis=(1, 2)) * _CV_SCALE
    a12 = jnp.sum(ixw * iyw, axis=(1, 2)) * _CV_SCALE
    a22 = jnp.sum(iyw * iyw, axis=(1, 2)) * _CV_SCALE
    det = a11 * a22 - a12 * a12
    min_eig = (
        a22 + a11 - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)
    ) / (2.0 * win_w * win_h)
    bad_tensor = (min_eig < params.min_eig_threshold) | (det < _FLT_EPSILON)
    bad_tmpl = oob_tmpl | bad_tensor
    if level == 0:
        status = status & ~bad_tmpl
    inv_det = jnp.where(det > 0, 1.0 / det, 0.0)

    if params.slab_margin is not None:
        # fast path: one slab per point; iteration windows come from
        # masked static slices instead of per-iteration dynamic slices
        margin = params.slab_margin
        m2 = 2 * margin
        slab_s = max(win_w, win_h) + m2 + 2
        slab_base = jnp.floor(next_tl0).astype(jnp.int32) - margin + pad  # [x,y]
        hp, wp = img_next_p.shape
        slab_base = jnp.clip(
            slab_base, 0, jnp.array([wp - slab_s, hp - slab_s], jnp.int32)
        )
        slabs = extract_slabs(img_next_p, slab_base, slab_s)

        def sample_next(next_tl):
            itl = jnp.floor(next_tl)
            frac = (next_tl - itl).astype(slabs.dtype)
            offsets = itl.astype(jnp.int32) + pad - slab_base
            raw = select_windows(slabs, offsets, win_h, win_w, m2)
            return blend_bilinear(raw, frac, win_h, win_w)

    else:

        def sample_next(next_tl):
            return extract_patches(img_next_p, next_tl + pad_off, win_h, win_w)

    def body(j, carry):
        next_tl, prev_delta, active, status = carry
        inext = jnp.floor(next_tl)
        oob = (
            (inext[:, 0] < -win_w)
            | (inext[:, 0] >= w)
            | (inext[:, 1] < -win_h)
            | (inext[:, 1] >= h)
        )
        if level == 0:
            status = status & ~(active & oob)
        active = active & ~oob

        jw = _fix(sample_next(next_tl))
        diff = jw - iw
        b1 = jnp.sum(diff * ixw, axis=(1, 2)) * _CV_SCALE
        b2 = jnp.sum(diff * iyw, axis=(1, 2)) * _CV_SCALE
        delta = jnp.stack(
            [(a12 * b2 - a22 * b1) * inv_det, (a12 * b1 - a11 * b2) * inv_det],
            axis=-1,
        )
        next_tl = jnp.where(active[:, None], next_tl + delta, next_tl)
        converged = jnp.sum(delta * delta, axis=-1) <= eps2
        osc = (
            (j > 0)
            & (jnp.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01)
            & (jnp.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
        )
        # converged wins over oscillation (OpenCV checks eps first)
        osc = osc & ~converged
        next_tl = jnp.where((active & osc)[:, None], next_tl - delta * 0.5, next_tl)
        active = active & ~(converged | osc)
        return next_tl, delta, active, status

    active0 = ~bad_tmpl
    next_tl, _, _, status = lax.fori_loop(
        0, params.max_iters, body, (next_tl0, jnp.zeros_like(next_tl0), active0, status)
    )

    # err at level 0: mean |window residual| (OpenCV's default err output,
    # descaled from its x32 fixed point)
    if level == 0 and params.compute_err:
        jw = extract_patches(img_next_p, next_tl + pad_off, win_h, win_w)
        err = jnp.sum(jnp.abs(jw - iw), axis=(1, 2)) / (win_w * win_h)
        err = jnp.where(status, err, 0.0)
    else:
        err = jnp.zeros(pts.shape[0], jnp.float32)
    return next_tl, status, err


def pyr_lk(
    img_prev: jnp.ndarray,
    img_next: jnp.ndarray,
    pts: jnp.ndarray,
    params: LKParams = LKParams(),
) -> LKResult:
    """Track pts (N, 2) [x, y] from img_prev to img_next.

    Images are (H, W) float32 grayscale in [0, 255]. Returns OpenCV-layout
    results: next point positions, per-point status, residual error.
    """
    # OpenCV stores LK pyramid levels as uint8; prepare_frame reproduces
    # that rounding (and pre-pads everything for window sampling)
    prep_prev = prepare_frame(img_prev, params)
    prep_next = prepare_frame(img_next, params)
    return pyr_lk_prepared(prep_prev, prep_next, pts, params)


def pyr_lk_prepared(
    prep_prev: PreparedFrame,
    prep_next: PreparedFrame,
    pts: jnp.ndarray,
    params: LKParams = LKParams(),
) -> LKResult:
    """pyr_lk over frames prepared with prepare_frame — the form video
    scans use so each frame's pyramid is built once, not twice."""
    pts = pts.astype(jnp.float32)
    status = jnp.ones(pts.shape[0], dtype=bool)
    err = jnp.zeros(pts.shape[0], jnp.float32)
    next_center = pts * jnp.float32(1.0 / (1 << params.max_level))
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            next_center = next_center * 2.0
        next_center, status, err = _level_lk(
            prep_prev, prep_next, pts, next_center, status, level, params
        )
    return LKResult(next_pts=next_center, status=status, err=err)
