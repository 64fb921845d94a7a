"""Gaussian image pyramids.

Replaces the pyramid construction hidden inside OpenCV's
calcOpticalFlowPyrLK (buildOpticalFlowPyramid -> pyrDown, reference call
site pathfinder_viewer.py:156 with maxLevel=2) with XLA convolutions:
5-tap [1,4,6,4,1]/16 separable smoothing, BORDER_REFLECT_101, and
ceil-halving subsampling — bit-faithful to cv2.pyrDown in float.
"""

from __future__ import annotations

import jax.numpy as jnp

from .image import sep_conv2d

_PYR_K = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def pyr_down(img: jnp.ndarray, quantize_u8: bool = False) -> jnp.ndarray:
    """cv2.pyrDown parity: 5-tap Gaussian then take every other pixel.
    Output spatial size is ((H+1)//2, (W+1)//2).

    quantize_u8 reproduces OpenCV's uint8 pyramid storage (fixed-point
    accumulate, round-half-up descale) while keeping float dtype."""
    smoothed = sep_conv2d(img, _PYR_K, _PYR_K, mode="reflect")
    # even-index subsample via pad+reshape+slice (a reshape and a static
    # slice, which XLA fuses into the consumer)
    h, w = smoothed.shape[-2:]
    if h % 2:
        smoothed = jnp.pad(smoothed, [(0, 0)] * (smoothed.ndim - 2) + [(0, 1), (0, 0)])
    s2 = smoothed.reshape(smoothed.shape[:-2] + ((h + 1) // 2, 2, w))[..., 0, :]
    if w % 2:
        s2 = jnp.pad(s2, [(0, 0)] * (s2.ndim - 1) + [(0, 1)])
    out = s2.reshape(s2.shape[:-1] + ((w + 1) // 2, 2))[..., 0]
    if quantize_u8:
        out = jnp.clip(jnp.floor(out + 0.5), 0.0, 255.0)
    return out


def build_pyramid(
    img: jnp.ndarray, max_level: int, quantize_u8: bool = False
) -> list[jnp.ndarray]:
    """Levels [0..max_level], level 0 is the input image.

    quantize_u8=True matches buildOpticalFlowPyramid's uint8 levels (the
    LK parity path); False keeps full float precision (preferred when not
    chasing bit-parity)."""
    levels = [img]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1], quantize_u8=quantize_u8))
    return levels
