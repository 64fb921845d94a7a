"""One pyramid level of the LK Gauss-Newton loop as a Pallas kernel on the
Triton route (NVIDIA GPUs).

Same arithmetic as the XLA form in ops/lk.py `_level_lk` (slab_margin
None): bilinear template sampling with the W_BITS `_fix` quantization,
the 2x2 structure tensor with OpenCV's fixed-point scale, the min-eigen
and determinant gates, up to max_iters Gauss-Newton steps with the eps
test and the oscillation damper, the oob/status rules and the level-0
residual err. Only the order of the window sums differs.

One program tracks one point. Its template and gradients stay in
registers for the whole loop; each step reads the four bilinear taps of
its window straight from the padded level image (L2-resident at 1080p),
and a point leaves the loop as soon as it converges, oscillates or
leaves the frame. Window tiles are the next powers of two of the window
(45 -> 64) with the padding lanes masked to zero. Index tiles are clamped
inside the window, so no load ever leaves the plane: the kernel runs the
same in the Pallas interpreter, which the CPU tests use.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_FLT_EPSILON = 1.1920929e-07
_CV_SCALE = 1.0 / 1024.0


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _fix(x):
    return jnp.floor(x * 32.0 + 0.5) * (1.0 / 32.0)


def _sum2(x):
    return jnp.sum(jnp.sum(x, axis=1), axis=0)


def _kernel(
    prev_ref, dx_ref, dy_ref, next_ref, pts_ref, tl0_ref, st_ref,
    tl_out, st_out, err_out,
    *, level, win_w, win_h, bh, bw, pad, h, w, hp, wp, max_iters, eps2,
    min_eig_threshold, compute_err,
):
    pid = pl.program_id(0)
    rows = lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    cols = lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    valid = (rows < win_h) & (cols < win_w)
    # flat offsets of the window inside a plane, clamped to the window so
    # the padding lanes re-read its last row/column (and stay in bounds)
    offs = jnp.minimum(rows, win_h - 1) * wp + jnp.minimum(cols, win_w - 1)
    pad_f = jnp.float32(pad)

    def origin(x, y):
        # extract_patches: floor of the padded position, shared fractional
        # weights, start clamped like lax.dynamic_slice
        fx = jnp.floor(x + pad_f)
        fy = jnp.floor(y + pad_f)
        ax = x + pad_f - fx
        ay = y + pad_f - fy
        sx = jnp.clip(fx.astype(jnp.int32), 0, wp - win_w - 1)
        sy = jnp.clip(fy.astype(jnp.int32), 0, hp - win_h - 1)
        wts = ((1 - ax) * (1 - ay), ax * (1 - ay), (1 - ax) * ay, ax * ay)
        return offs + sy * wp + sx, wts

    def sample(ref, idx, wts):
        w00, w10, w01, w11 = wts
        return (
            ref[idx] * w00 + ref[idx + 1] * w10
            + ref[idx + wp] * w01 + ref[idx + wp + 1] * w11
        )

    def outside(x, y):
        ix = jnp.floor(x)
        iy = jnp.floor(y)
        return (ix < -win_w) | (ix >= w) | (iy < -win_h) | (iy >= h)

    scale = jnp.float32(1.0 / (1 << level))
    half_w = jnp.float32((win_w - 1) * 0.5)
    half_h = jnp.float32((win_h - 1) * 0.5)
    tx = pts_ref[pid, 0] * scale - half_w
    ty = pts_ref[pid, 1] * scale - half_h
    tidx, twts = origin(tx, ty)
    zero = jnp.zeros((bh, bw), jnp.float32)
    iw = jnp.where(valid, _fix(sample(prev_ref, tidx, twts)), zero)
    ixw = jnp.where(valid, _fix(sample(dx_ref, tidx, twts)), zero)
    iyw = jnp.where(valid, _fix(sample(dy_ref, tidx, twts)), zero)

    a11 = _sum2(ixw * ixw) * _CV_SCALE
    a12 = _sum2(ixw * iyw) * _CV_SCALE
    a22 = _sum2(iyw * iyw) * _CV_SCALE
    det = a11 * a22 - a12 * a12
    min_eig = (
        a22 + a11 - jnp.sqrt((a11 - a22) * (a11 - a22) + 4.0 * a12 * a12)
    ) / (2.0 * win_w * win_h)
    bad = (
        outside(tx, ty) | (min_eig < min_eig_threshold) | (det < _FLT_EPSILON)
    )
    status = st_ref[pid] != 0
    if level == 0:
        status = status & ~bad
    inv_det = jnp.where(det > 0, 1.0 / det, 0.0)

    def cond(carry):
        j, _, _, _, _, active, _ = carry
        return (j < max_iters) & active

    def body(carry):
        j, x, y, pdx, pdy, active, status = carry
        oob = outside(x, y)
        if level == 0:
            status = status & ~(active & oob)
        active = active & ~oob
        idx, wts = origin(x, y)
        diff = _fix(sample(next_ref, idx, wts)) - iw
        # ixw/iyw are zero on the padding lanes, so no mask is needed
        b1 = _sum2(diff * ixw) * _CV_SCALE
        b2 = _sum2(diff * iyw) * _CV_SCALE
        dx = (a12 * b2 - a22 * b1) * inv_det
        dy = (a12 * b1 - a11 * b2) * inv_det
        x = jnp.where(active, x + dx, x)
        y = jnp.where(active, y + dy, y)
        converged = dx * dx + dy * dy <= eps2
        osc = (
            (j > 0)
            & (jnp.abs(dx + pdx) < 0.01)
            & (jnp.abs(dy + pdy) < 0.01)
            & ~converged
        )
        x = jnp.where(active & osc, x - dx * 0.5, x)
        y = jnp.where(active & osc, y - dy * 0.5, y)
        active = active & ~(converged | osc)
        return j + 1, x, y, dx, dy, active, status

    x0 = tl0_ref[pid, 0]
    y0 = tl0_ref[pid, 1]
    _, x, y, _, _, _, status = lax.while_loop(
        cond,
        body,
        (jnp.int32(0), x0, y0, jnp.float32(0), jnp.float32(0), ~bad, status),
    )
    tl_out[pid, 0] = x
    tl_out[pid, 1] = y
    st_out[pid] = status.astype(jnp.int32)
    if compute_err:
        idx, wts = origin(x, y)
        resid = jnp.where(valid, jnp.abs(sample(next_ref, idx, wts) - iw), zero)
        err = _sum2(resid) / (win_w * win_h)
        err_out[pid] = jnp.where(status, err, 0.0)
    else:
        err_out[pid] = jnp.float32(0)


def level_lk_triton(
    img_prev_p: jnp.ndarray,
    dix_p: jnp.ndarray,
    diy_p: jnp.ndarray,
    img_next_p: jnp.ndarray,
    pts: jnp.ndarray,
    next_tl0: jnp.ndarray,
    status: jnp.ndarray,
    *,
    level: int,
    win_size: tuple[int, int],
    pad: int,
    max_iters: int,
    eps: float,
    min_eig_threshold: float,
    compute_err: bool,
    interpret: bool = False,
):
    """Track (N, 2) points through one level. Planes are the padded
    (H+2p, W+2p) level images of ops/lk.PreparedFrame; `pts` are the
    full-resolution template centres, `next_tl0` the initial window
    top-left at this level. Returns (next_tl (N, 2), status (N,) bool,
    err (N,) — zero unless level 0 and compute_err)."""
    win_w, win_h = win_size
    hp, wp = img_prev_p.shape
    n = pts.shape[0]
    bh, bw = _pow2(win_h), _pow2(win_w)
    kernel = functools.partial(
        _kernel,
        level=level, win_w=win_w, win_h=win_h, bh=bh, bw=bw, pad=pad,
        h=hp - 2 * pad, w=wp - 2 * pad, hp=hp, wp=wp, max_iters=max_iters,
        eps2=float(max(eps, 0.0) ** 2), min_eig_threshold=min_eig_threshold,
        compute_err=compute_err and level == 0,
    )
    tl, st, err = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((n, 2), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.float32),
        ),
        grid=(n,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(8, bh * bw // 512)), num_stages=1
        ),
        interpret=interpret,
        name=f"lk_level{level}_w{win_w}",
    )(
        img_prev_p.reshape(-1),
        dix_p.reshape(-1),
        diy_p.reshape(-1),
        img_next_p.reshape(-1),
        pts.astype(jnp.float32),
        next_tl0.astype(jnp.float32),
        status.astype(jnp.int32),
    )
    return tl, st != 0, err
