"""Farneback dense optical flow.

From-scratch XLA implementation numerically faithful to
cv2.calcOpticalFlowFarneback as called by the reference
(DenseOF.py:127-157: pyr_scale 0.5, levels 3, winsize 15, iterations 3,
poly_n 5, poly_sigma 1.2, flags 0):

- per-level image preparation: GaussianBlur of the full-resolution frame
  with sigma = (1/scale - 1)/2 (kernel round(5*sigma)|1, min 3) followed by
  an INTER_LINEAR resize — not a recursive pyramid;
- polynomial expansion: separable Gaussian-weighted moment correlations
  {g, x*g, x^2*g} (replicate borders) combined through the inverse Gram
  matrix entries (ig11, ig03, ig33, ig55) into the 5 coefficient channels
  [b_y, b_x, a_yy, a_xx, a_xy-ish] — separable multiply-adds;
- matrix update: bilinear warp of the second image's coefficients by the
  current flow, averaging of the quadratic terms, delta-b linearized at the
  prior flow, the OpenCV edge down-weighting band (BORDER=5), producing the
  5-channel normal-equation field M;
- flow update: un-normalized box sums of M over winsize (replicate border)
  and the damped 2x2 Cramer solve (det + 1e-3);
- coarse-to-fine: INTER_LINEAR flow upscale times 1/pyr_scale.

The whole computation is dense (H, W) tensor algebra with static shapes —
plain XLA; the only gather is the bilinear coefficient warp.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import FarnebackParams
from .image import gaussian_blur, resize_bilinear, sep_conv2d, box_sum

# OpenCV edge down-weighting band (optflowgf.cpp FarnebackUpdateMatrices).
_BORDER = 5
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


@functools.lru_cache(maxsize=None)
def _poly_exp_consts(n: int, sigma: float):
    """Gaussian moment taps and inverse-Gram entries (float64 host math,
    as OpenCV's FarnebackPrepareGaussian)."""
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    # Gram matrix of basis {1, x, y, x^2, y^2, xy} under w(x,y)=g(x)g(y)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    w = np.outer(g, g)
    basis = np.stack(
        [np.ones_like(xx), xx, yy, xx**2, yy**2, xx * yy], axis=0
    ).reshape(6, -1)
    G = (basis * w.reshape(1, -1)) @ basis.T
    invG = np.linalg.inv(G)
    ig11 = invG[1, 1]
    ig03 = invG[0, 3]
    ig33 = invG[3, 3]
    ig55 = invG[5, 5]
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(ig11),
        float(ig03),
        float(ig33),
        float(ig55),
    )


def poly_exp(img: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """Polynomial expansion -> (5, H, W) coefficient channels
    [0]=b_y, [1]=b_x, [2]=a_yy, [3]=a_xx, [4]=cross."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    g = jnp.asarray(g)
    xg = jnp.asarray(xg)
    xxg = jnp.asarray(xxg)
    one = jnp.array([1.0], img.dtype)

    # vertical moment pass (replicate border)
    s0 = sep_conv2d(img, g, one, mode="edge")
    s1 = sep_conv2d(img, xg, one, mode="edge")
    s2 = sep_conv2d(img, xxg, one, mode="edge")
    # horizontal combination pass
    b1 = sep_conv2d(s0, one, g, mode="edge")
    b2 = sep_conv2d(s0, one, xg, mode="edge")
    b3 = sep_conv2d(s1, one, g, mode="edge")
    b4 = sep_conv2d(s2, one, g, mode="edge")
    b5 = sep_conv2d(s0, one, xxg, mode="edge")
    b6 = sep_conv2d(s1, one, xg, mode="edge")

    return jnp.stack(
        [
            b3 * ig11,
            b2 * ig11,
            b1 * ig03 + b4 * ig33,
            b1 * ig03 + b5 * ig33,
            b6 * ig55,
        ],
        axis=0,
    )


def _border_factor(h: int, w: int) -> jnp.ndarray:
    """Per-pixel edge down-weighting (1 in the interior)."""
    def axis_f(n):
        f = np.ones((n,), np.float32)
        b = min(_BORDER, n)
        f[:b] *= _BORDER_SCALE[:b]
        f[n - b :] *= _BORDER_SCALE[:b][::-1]
        return f

    return jnp.asarray(np.outer(axis_f(h), axis_f(w)))


def update_matrices(
    r0: jnp.ndarray,
    r1: jnp.ndarray,
    flow: jnp.ndarray,
    mode: str = "exact",
) -> jnp.ndarray:
    """Build the 5-channel normal-equation field M from the polynomial
    coefficients of both frames and the current flow. (OpenCV
    FarnebackUpdateMatrices parity.)

    mode selects the bilinear-warp implementation: 'exact' (flat element
    gathers) or 'packed' (bf16-pair gathers, 12 elements/px)."""
    _, h, w = r0.shape
    dx = flow[..., 0]
    dy = flow[..., 1]
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=flow.dtype), jnp.arange(w, dtype=flow.dtype), indexing="ij"
    )
    fx = xs + dx
    fy = ys + dy
    x1 = jnp.floor(fx)
    y1 = jnp.floor(fy)
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    ax = (fx - x1).astype(r1.dtype)
    ay = (fy - y1).astype(r1.dtype)
    x1i = jnp.clip(x1.astype(jnp.int32), 0, w - 2)
    y1i = jnp.clip(y1.astype(jnp.int32), 0, h - 2)

    if mode == "packed":
        w2 = _warp5_packed(r1, y1i, x1i, ax, ay, h, w)
        return _assemble_m(r0, w2, inside, dx, dy, h, w)

    # flattened-index element gathers: one 1-element gather per corner
    # and channel, which XLA fuses with the blend below
    lin = (y1i * w + x1i).reshape(-1)
    corners = jnp.stack([lin, lin + 1, lin + w, lin + w + 1], axis=0)  # (4, N)
    rf = r1.reshape(5, h * w)
    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay
    wts = jnp.stack([w00, w10, w01, w11], axis=0).reshape(4, 1, h, w)

    vals = jnp.stack(
        [jnp.take(rf[c], corners, axis=0).reshape(4, h, w) for c in range(5)],
        axis=1,
    )  # (4, 5, H, W)
    w2 = jnp.sum(vals * wts, axis=0)
    return _assemble_m(r0, w2, inside, dx, dy, h, w)


def _assemble_m(r0, w2, inside, dx, dy, h, w) -> jnp.ndarray:
    """Averaging, delta-b linearization, border weighting and normal-
    equation assembly shared by the warp variants."""
    r2 = jnp.where(inside, w2[0], 0.0)
    r3 = jnp.where(inside, w2[1], 0.0)
    r4 = jnp.where(inside, (r0[2] + w2[2]) * 0.5, r0[2])
    r5 = jnp.where(inside, (r0[3] + w2[3]) * 0.5, r0[3])
    r6 = jnp.where(inside, (r0[4] + w2[4]) * 0.25, r0[4] * 0.5)

    r2 = (r0[0] - r2) * 0.5
    r3 = (r0[1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    scale = _border_factor(h, w)
    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return jnp.stack(
        [
            r4 * r4 + r6 * r6,  # G_yy
            (r4 + r5) * r6,  # G_xy
            r5 * r5 + r6 * r6,  # G_xx
            r4 * r2 + r6 * r3,  # rhs_y
            r6 * r2 + r5 * r3,  # rhs_x
        ],
        axis=0,
    )


def _warp5_packed(r1: jnp.ndarray, y1i, x1i, ax, ay, h, w) -> jnp.ndarray:
    """Bilinear warp of the 5 coefficient channels with bf16 pairs packed
    into u32 words: 12 gathered elements per pixel instead of 20 (element
    count is the gather's cost unit). The packed channels
    round to bf16 (~0.4% rel) — used by warp_mode='packed'."""
    def pack(a, b):
        ab = jax.lax.bitcast_convert_type(a.astype(jnp.bfloat16), jnp.uint16)
        bb = jax.lax.bitcast_convert_type(b.astype(jnp.bfloat16), jnp.uint16)
        return ab.astype(jnp.uint32) | (bb.astype(jnp.uint32) << 16)

    p01 = pack(r1[0], r1[1]).reshape(-1)
    p23 = pack(r1[2], r1[3]).reshape(-1)
    c4 = r1[4].reshape(-1)

    lin = (y1i * w + x1i).reshape(-1)
    corners = jnp.stack([lin, lin + 1, lin + w, lin + w + 1], axis=0)  # (4, N)
    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay
    wts = jnp.stack([w00, w10, w01, w11], axis=0).reshape(4, h, w)

    def unpack(u):
        lo = jax.lax.bitcast_convert_type((u & 0xFFFF).astype(jnp.uint16), jnp.bfloat16)
        hi = jax.lax.bitcast_convert_type((u >> 16).astype(jnp.uint16), jnp.bfloat16)
        return lo.astype(jnp.float32), hi.astype(jnp.float32)

    g01 = jnp.take(p01, corners, axis=0).reshape(4, h, w)
    g23 = jnp.take(p23, corners, axis=0).reshape(4, h, w)
    g4 = jnp.take(c4, corners, axis=0).reshape(4, h, w)
    c0, c1 = unpack(g01)
    c2, c3 = unpack(g23)
    chans = [c0, c1, c2, c3, g4]
    return jnp.stack([jnp.sum(ch * wts, axis=0) for ch in chans], axis=0)


def update_matrices_prewarped(
    r0: jnp.ndarray, r1w: jnp.ndarray, flow: jnp.ndarray
) -> jnp.ndarray:
    """update_matrices when r1w is ALREADY displaced by the current flow
    (the "image" warp mode: the grayscale frame is warped once per
    iteration — a 1-channel gather instead of 5 — and re-expanded; here
    the coefficients are consumed in place). Identical averaging,
    linearization, border weighting and normal-equation assembly."""
    _, h, w = r0.shape
    dx = flow[..., 0]
    dy = flow[..., 1]
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=flow.dtype), jnp.arange(w, dtype=flow.dtype), indexing="ij"
    )
    inside = (
        (xs + dx >= 0) & (xs + dx < w - 1) & (ys + dy >= 0) & (ys + dy < h - 1)
    )

    r2 = jnp.where(inside, r1w[0], 0.0)
    r3 = jnp.where(inside, r1w[1], 0.0)
    r4 = jnp.where(inside, (r0[2] + r1w[2]) * 0.5, r0[2])
    r5 = jnp.where(inside, (r0[3] + r1w[3]) * 0.5, r0[3])
    r6 = jnp.where(inside, (r0[4] + r1w[4]) * 0.25, r0[4] * 0.5)

    r2 = (r0[0] - r2) * 0.5
    r3 = (r0[1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    scale = _border_factor(h, w)
    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return jnp.stack(
        [
            r4 * r4 + r6 * r6,
            (r4 + r5) * r6,
            r5 * r5 + r6 * r6,
            r4 * r2 + r6 * r3,
            r6 * r2 + r5 * r3,
        ],
        axis=0,
    )


def update_flow_blur(m: jnp.ndarray, win_size: int) -> jnp.ndarray:
    """Solve for flow from box-averaged M (OpenCV FarnebackUpdateFlow_blur:
    window sums scaled by 1/win^2, then the 1e-3-damped 2x2 Cramer solve).
    The window sums use ops/image.box_sum (doubling partial sums)."""
    ms = box_sum(m, win_size, mode="edge")
    return _cramer_solve(ms * (1.0 / (win_size * win_size)))


@functools.lru_cache(maxsize=None)
def _gauss_win_kernel(win_size: int) -> np.ndarray:
    """OpenCV FarnebackUpdateFlow_GaussianBlur's window kernel: half-width
    m = win//2, sigma = m*0.3, normalized over the full 2m+1 taps."""
    m = win_size // 2
    sigma = m * 0.3
    half = np.exp(-np.arange(m + 1, dtype=np.float64) ** 2 / (2 * sigma * sigma))
    s = half[0] + 2.0 * half[1:].sum()
    half = (half / s).astype(np.float32)
    return np.concatenate([half[:0:-1], half])


def update_flow_gaussian(m: jnp.ndarray, win_size: int) -> jnp.ndarray:
    """FARNEBACK_GAUSSIAN variant (OpenCV FarnebackUpdateFlow_GaussianBlur):
    the window sum is a normalized separable Gaussian (sigma = (win//2)*0.3,
    replicate borders) instead of a box, then the same damped solve."""
    k = jnp.asarray(_gauss_win_kernel(win_size))
    ms = jnp.stack([sep_conv2d(ch, k, k, mode="edge") for ch in m], axis=0)
    return _cramer_solve(ms)


def _cramer_solve(ms: jnp.ndarray) -> jnp.ndarray:
    g11, g12, g22, h1, h2 = ms[0], ms[1], ms[2], ms[3], ms[4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return jnp.stack([fx, fy], axis=-1)


def _level_shapes(h: int, w: int, params: FarnebackParams):
    """(hk, wk, sigma, smooth_sz) per level, coarse -> fine (OpenCV scales
    each level from the ORIGINAL size, not recursively)."""
    out = []
    for k in range(params.levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)
        out.append((int(round(h * scale)), int(round(w * scale)), sigma, smooth_sz))
    return out


def prepare_frame(
    img: jnp.ndarray, params: FarnebackParams = FarnebackParams()
) -> tuple[jnp.ndarray, ...]:
    """Per-level polynomial-expansion pyramid of ONE frame, coarse -> fine.

    In a video scan each frame is the `nxt` of one pair and the `prev` of
    the following pair; preparing it once halves the poly_exp / blur /
    resize work of the pairwise farneback() (cf. cv2's per-call recompute
    behind DenseOF.py:147-157, which gets no such reuse)."""
    img = img.astype(jnp.float32)
    h, w = img.shape
    rs = []
    for hk, wk, sigma, smooth_sz in _level_shapes(h, w, params):
        smoothed = gaussian_blur(img, smooth_sz, sigma)
        if (hk, wk) != (h, w):
            smoothed = resize_bilinear(smoothed, hk, wk)
        rs.append(poly_exp(smoothed, params.poly_n, params.poly_sigma))
    return tuple(rs)


def _init_top_flow(flow0, hk: int, wk: int, scale: float) -> jnp.ndarray:
    """OPTFLOW_USE_INITIAL_FLOW seed at the top pyramid level: INTER_AREA
    resize of the caller's full-resolution flow, scaled by the level's
    pyramid scale (OpenCV calcOpticalFlowFarneback's `if( flags &
    OPTFLOW_USE_INITIAL_FLOW )` branch)."""
    from .image import resize_area

    f = jnp.moveaxis(flow0.astype(jnp.float32), -1, 0)
    if f.shape[1:] != (hk, wk):
        f = jnp.stack([resize_area(f[0], hk, wk), resize_area(f[1], hk, wk)])
    return jnp.moveaxis(f, 0, -1) * scale


def _solve_flow(m: jnp.ndarray, params: FarnebackParams) -> jnp.ndarray:
    if params.gaussian_win:
        return update_flow_gaussian(m, params.win_size)
    return update_flow_blur(m, params.win_size)


def farneback_prepared(
    rs_prev: tuple[jnp.ndarray, ...],
    rs_next: tuple[jnp.ndarray, ...],
    params: FarnebackParams = FarnebackParams(),
    flow0: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """farneback() on prepare_frame() pyramids (coefficient warp modes
    only — 'image'/'hybrid' re-expand inside the iteration and gain
    nothing from preparation). Numerics identical to farneback()."""
    if params.warp_mode not in ("exact", "packed"):
        raise ValueError(
            f"farneback_prepared needs a coefficient warp mode (exact, "
            f"packed), got {params.warp_mode!r}"
        )
    flow = None
    for r0, r1 in zip(rs_prev, rs_next):
        _, hk, wk = r0.shape
        if flow is None:
            if flow0 is not None:
                flow = _init_top_flow(
                    flow0, hk, wk, params.pyr_scale**params.levels
                )
            else:
                flow = jnp.zeros((hk, wk, 2), jnp.float32)
        else:
            flow = jnp.moveaxis(
                resize_bilinear(jnp.moveaxis(flow, -1, 0), hk, wk), 0, -1
            ) * (1.0 / params.pyr_scale)
        m = update_matrices(r0, r1, flow, mode=params.warp_mode)
        for i in range(params.iterations):
            flow = _solve_flow(m, params)
            if i < params.iterations - 1:
                m = update_matrices(r0, r1, flow, mode=params.warp_mode)
    return flow


def farneback(
    prev: jnp.ndarray,
    nxt: jnp.ndarray,
    params: FarnebackParams = FarnebackParams(),
    flow0: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Dense flow (H, W, 2) from prev to nxt grayscale (H, W) frames in
    [0, 255]. cv2.calcOpticalFlowFarneback parity; flags map onto
    FarnebackParams.gaussian_win (OPTFLOW_FARNEBACK_GAUSSIAN) and the
    flow0 argument (OPTFLOW_USE_INITIAL_FLOW — pass the previous flow)."""
    prev = prev.astype(jnp.float32)
    nxt = nxt.astype(jnp.float32)
    h, w = prev.shape

    flow = None
    for k in range(params.levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)
        wk = int(round(w * scale))
        hk = int(round(h * scale))

        if flow is None:
            if flow0 is not None:
                flow = _init_top_flow(flow0, hk, wk, scale)
            else:
                flow = jnp.zeros((hk, wk, 2), jnp.float32)
        else:
            flow = resize_bilinear(
                jnp.moveaxis(flow, -1, 0), hk, wk
            )
            flow = jnp.moveaxis(flow, 0, -1) * (1.0 / params.pyr_scale)

        imgs = []
        for img in (prev, nxt):
            smoothed = gaussian_blur(img, smooth_sz, sigma)
            if (hk, wk) != (h, w):
                smoothed = resize_bilinear(smoothed, hk, wk)
            imgs.append(smoothed)
        r0 = poly_exp(imgs[0], params.poly_n, params.poly_sigma)

        if params.warp_mode in ("image", "hybrid"):
            from .warp import warp_image

            def make_m_img(fl):
                r1w = poly_exp(
                    warp_image(imgs[1], fl), params.poly_n, params.poly_sigma
                )
                return update_matrices_prewarped(r0, r1w, fl)

        if params.warp_mode in ("exact", "hybrid", "packed"):
            r1 = poly_exp(imgs[1], params.poly_n, params.poly_sigma)
            coef_mode = params.warp_mode if params.warp_mode != "hybrid" else "exact"

            def make_m_exact(fl):
                return update_matrices(r0, r1, fl, mode=coef_mode)

        if params.warp_mode == "image":
            make_m_iter = make_m_final = make_m_img
        elif params.warp_mode == "hybrid":
            # cheap image-space warps drive the early iterations; the
            # level's final matrix update uses the exact coefficient warp
            # so the Gauss-Newton step that produces the output flow is
            # OpenCV-faithful (2x fewer gathered elements overall)
            make_m_iter, make_m_final = make_m_img, make_m_exact
        else:
            make_m_iter = make_m_final = make_m_exact

        m = make_m_iter(flow) if params.iterations > 1 else make_m_final(flow)
        for i in range(params.iterations):
            flow = _solve_flow(m, params)
            if i < params.iterations - 1:
                m = (
                    make_m_final(flow)
                    if i == params.iterations - 2
                    else make_m_iter(flow)
                )
    return flow
