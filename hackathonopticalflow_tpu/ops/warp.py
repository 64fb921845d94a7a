"""Dense bilinear sampling / warping.

Used by the Farneback dense-flow iteration (sampling the second image's
polynomial-expansion coefficients at positions displaced by the current
flow — OpenCV FarnebackUpdateMatrices' inner bilinear fetch) and available
as a general remap primitive.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_sample(img: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray) -> jnp.ndarray:
    """Sample img (..., H, W) at float coords (broadcastable xs, ys).

    Out-of-range coordinates are clamped to the border pixel.
    """
    h, w = img.shape[-2:]
    x = jnp.clip(xs, 0.0, w - 1.0)
    y = jnp.clip(ys, 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, max(w - 2, 0))
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, max(h - 2, 0))
    ax = (x - x0).astype(img.dtype)
    ay = (y - y0).astype(img.dtype)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)

    if img.ndim == 2 and x0.shape == y0.shape:
        # flattened-index element gathers: one 1-element gather per corner
        lin = (y0 * w + x0).reshape(-1)
        shape = x0.shape
        corners = jnp.stack(
            [lin, lin + (x1 - x0).reshape(-1), (y1 - y0).reshape(-1) * w + lin,
             (y1 - y0).reshape(-1) * w + lin + (x1 - x0).reshape(-1)],
            axis=0,
        )
        vals = jnp.take(img.reshape(-1), corners, axis=0).reshape((4,) + shape)
        w00 = (1 - ax) * (1 - ay)
        w10 = ax * (1 - ay)
        w01 = (1 - ax) * ay
        w11 = ax * ay
        return vals[0] * w00 + vals[1] * w10 + vals[2] * w01 + vals[3] * w11

    def gather(yy, xx):
        return img[..., yy, xx]

    v00 = gather(y0, x0)
    v10 = gather(y0, x1)
    v01 = gather(y1, x0)
    v11 = gather(y1, x1)
    return (
        v00 * (1 - ax) * (1 - ay)
        + v10 * ax * (1 - ay)
        + v01 * (1 - ax) * ay
        + v11 * ax * ay
    )


def warp_image(img: jnp.ndarray, flow: jnp.ndarray) -> jnp.ndarray:
    """Backward-warp img by flow: out(p) = img(p + flow(p)).

    img: (H, W); flow: (H, W, 2) with [dx, dy] channels.
    """
    h, w = img.shape[-2:]
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=flow.dtype), jnp.arange(w, dtype=flow.dtype), indexing="ij"
    )
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1])
