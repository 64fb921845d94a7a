"""Dense image primitives: separable convolution, Gaussian blur, box sums,
OpenCV-compatible resizes, thresholding.

These replace the OpenCV C++ kernels the reference calls through cv2
(GaussianBlur: Operations.py:55-56; resize: Operations.py:46,239;
threshold: Operations.py:58-60, DenseOF.py:396) with XLA-native ops.
All functions take (..., H, W) float32 arrays and are jit-friendly
(static shapes, no data-dependent control flow).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Parity-critical matrix products (resize_area) keep full f32: on the GPU
# a default-precision f32 matmul may run in TF32.
_PRECISION = lax.Precision.HIGHEST


def _correlate1d(x: jnp.ndarray, k: jnp.ndarray, axis: int) -> jnp.ndarray:
    """VALID correlation of an already-padded array with taps k along
    `axis`, as len(k) shifted multiply-adds in f32 (one fused loop)."""
    n_out = x.shape[axis] - len(k) + 1
    acc = None
    for t in range(len(k)):
        part = lax.slice_in_dim(x, t, t + n_out, axis=axis) * k[t]
        acc = part if acc is None else acc + part
    return acc


def sep_conv2d(
    img: jnp.ndarray,
    ky: jnp.ndarray,
    kx: jnp.ndarray,
    *,
    mode: str = "reflect",
) -> jnp.ndarray:
    """Separable 2-D correlation with border handling.

    mode: any jnp.pad mode — 'reflect' == cv2 BORDER_REFLECT_101 (default for
    GaussianBlur / Scharr), 'edge' == BORDER_REPLICATE, 'constant' == zeros.
    Output has the same spatial shape as the input. Both passes are
    shifted multiply-adds (see PERF.md for the form chosen on the GPU).
    """
    ky = jnp.asarray(ky, img.dtype)
    kx = jnp.asarray(kx, img.dtype)
    ry, rx = len(ky) // 2, len(kx) // 2
    pad = [(0, 0)] * (img.ndim - 2) + [(ry, ry), (rx, rx)]
    x = jnp.pad(img, pad, mode=mode)
    if len(ky) > 1:
        x = _correlate1d(x, ky, axis=img.ndim - 2)
    if len(kx) > 1:
        x = _correlate1d(x, kx, axis=img.ndim - 1)
    return x


_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel1d(ksize: int, sigma: float) -> jnp.ndarray:
    """cv2.getGaussianKernel semantics, including the fixed small-kernel
    tables used when sigma <= 0 and ksize <= 7."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return jnp.asarray(_SMALL_GAUSSIAN_TAB[ksize], jnp.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    import numpy as _np

    xs = _np.arange(ksize, dtype=_np.float64) - (ksize - 1) * 0.5
    k = _np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return jnp.asarray((k / k.sum()).astype(_np.float32))


def gaussian_blur(
    img: jnp.ndarray, ksize: int, sigma: float, *, mode: str = "reflect"
) -> jnp.ndarray:
    """cv2.GaussianBlur parity (BORDER_REFLECT_101 default)."""
    k = gaussian_kernel1d(ksize, sigma)
    return sep_conv2d(img, k, k, mode=mode)


def _box1d(x: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """Sliding window-of-k sum along `axis` of an already-padded array,
    via doubling: build power-of-2 partial sums (S_2p[i] = S_p[i] +
    S_p[i+p]) and combine k's binary decomposition — ceil(log2 k) +
    popcount(k) - 1 adds instead of k-1 (6 vs 14 for Farneback's
    winsize 15)."""

    def sl(a, start, length):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(start, start + length)
        return a[tuple(idx)]

    n = x.shape[axis]
    sums = {1: x}
    p = 1
    while 2 * p <= k:
        s = sums[p]
        m = s.shape[axis]
        sums[2 * p] = sl(s, 0, m - p) + sl(s, p, m - p)
        p *= 2
    out = None
    off, rem = 0, k
    out_len = n - k + 1
    for b in sorted(sums, reverse=True):
        if rem >= b:
            part = sl(sums[b], off, out_len)
            out = part if out is None else out + part
            off += b
            rem -= b
    return out


def box_sum(img: jnp.ndarray, ksize: int, *, mode: str = "edge") -> jnp.ndarray:
    """Unnormalized box sums over a ksize x ksize window (replicate border),
    as used by Farneback's flow averaging (OpenCV FarnebackUpdateFlow_blur)
    and cornerMinEigenVal's blockSize aggregation."""
    r = ksize // 2
    pad = [(0, 0)] * (img.ndim - 2) + [(r, r), (r, r)]
    x = jnp.pad(img, pad, mode=mode)
    x = _box1d(x, ksize, axis=-1)
    return _box1d(x, ksize, axis=-2)


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """cv2.resize INTER_LINEAR parity (half-pixel centers, clamped, NO
    antialiasing on downscale — unlike jax.image.resize)."""
    h, w = img.shape[-2:]
    scale_y = h / out_h
    scale_x = w / out_w
    # src = (dst + 0.5) * scale - 0.5
    sy = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * scale_y - 0.5
    sx = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * scale_x - 0.5
    sy = jnp.clip(sy, 0.0, h - 1.0)
    sx = jnp.clip(sx, 0.0, w - 1.0)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, h - 2) if h > 1 else jnp.zeros_like(sy, jnp.int32)
    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, w - 2) if w > 1 else jnp.zeros_like(sx, jnp.int32)
    wy = (sy - y0).astype(img.dtype) if h > 1 else jnp.zeros_like(sy, img.dtype)
    wx = (sx - x0).astype(img.dtype) if w > 1 else jnp.zeros_like(sx, img.dtype)

    rows0 = jnp.take(img, y0, axis=-2)
    rows1 = jnp.take(img, jnp.minimum(y0 + 1, h - 1), axis=-2)
    wy_b = wy.reshape((1,) * (img.ndim - 2) + (out_h, 1))
    rows = rows0 * (1 - wy_b) + rows1 * wy_b
    cols0 = jnp.take(rows, x0, axis=-1)
    cols1 = jnp.take(rows, jnp.minimum(x0 + 1, w - 1), axis=-1)
    wx_b = wx.reshape((1,) * (img.ndim - 2) + (1, out_w))
    return cols0 * (1 - wx_b) + cols1 * wx_b


def _area_weights(n_in: int, n_out: int):
    """(n_out, n_in) fractional pixel-coverage weights for cv2's generic
    INTER_AREA downscale: output cell j covers src span
    [j*scale, (j+1)*scale); border cells get partial coverage; rows are
    normalized by covered area (host-side numpy, static shapes)."""
    import numpy as _np

    scale = n_in / n_out
    w = _np.zeros((n_out, n_in), _np.float32)
    for j in range(n_out):
        a, b = j * scale, (j + 1) * scale
        lo, hi = int(_np.floor(a)), int(min(_np.ceil(b), n_in))
        for i in range(lo, hi):
            w[j, i] = min(b, i + 1) - max(a, i)
    return w / w.sum(axis=1, keepdims=True)


def resize_area(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """cv2.resize INTER_AREA parity: exact pixel-area average for integer
    shrink factors, fractional coverage weights for non-integer downscale
    (as cv2's generic area path), bilinear for upscale (cv2's behavior)."""
    h, w = img.shape[-2:]
    if h % out_h == 0 and w % out_w == 0 and h >= out_h and w >= out_w:
        fy, fx = h // out_h, w // out_w
        x = img.reshape(img.shape[:-2] + (out_h, fy, out_w, fx))
        return x.mean(axis=(-3, -1))
    if h >= out_h and w >= out_w:
        wy = jnp.asarray(_area_weights(h, out_h), img.dtype)
        wx = jnp.asarray(_area_weights(w, out_w), img.dtype)
        x = jnp.einsum("oh,...hw->...ow", wy, img, precision=_PRECISION)
        return jnp.einsum("...hw,ow->...ho", x, wx, precision=_PRECISION)
    return resize_bilinear(img, out_h, out_w)


def threshold_binary(img: jnp.ndarray, thresh: float, maxval: float = 255.0) -> jnp.ndarray:
    """cv2.threshold(..., THRESH_BINARY) parity: img > thresh -> maxval else 0."""
    return jnp.where(img > thresh, jnp.asarray(maxval, img.dtype), jnp.asarray(0, img.dtype))

