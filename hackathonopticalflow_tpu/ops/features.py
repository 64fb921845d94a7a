"""Shi-Tomasi corner detection (cv2.goodFeaturesToTrack parity).

Replaces the OpenCV C++ kernel the reference calls at SparseOF.py:69
(maxCorners 20, qualityLevel 0.3, minDistance 10, blockSize 7):

- cornerMinEigenVal: aperture-3 Sobel gradients with OpenCV's scale factor
  1 / (2^(aperture-1) * blockSize [* 255 for u8 inputs]), un-normalized
  blockSize box sums of the structure tensor, smallest-eigenvalue map —
  dense XLA convolutions;
- quality thresholding at maxVal * quality_level, 3x3 non-max suppression
  via reduce_window max-pool (1-pixel frame border excluded);
- descending-quality greedy min-distance selection as a fixed-trip
  fori_loop over the strongest `max_candidates` survivors (static shapes).

Returns fixed-capacity (max_corners, 2) coordinates plus a validity mask
(jit-friendly; hosts compact where needed).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.config import FeatureParams
from .deriv import sobel_deriv
from .image import box_sum


class Corners(NamedTuple):
    pts: jnp.ndarray  # (max_corners, 2) float32 [x, y]
    valid: jnp.ndarray  # (max_corners,) bool
    count: jnp.ndarray  # () int32


def min_eig_map(img: jnp.ndarray, block_size: int = 7, input_u8_scale: bool = True) -> jnp.ndarray:
    """cornerMinEigenVal parity: smallest eigenvalue of the block-summed
    structure tensor at every pixel."""
    scale = (1 << 2) * block_size
    if input_u8_scale:
        scale *= 255
    s = 1.0 / scale
    ix, iy = sobel_deriv(img.astype(jnp.float32))
    ix = ix * s
    iy = iy * s
    a = box_sum(ix * ix, block_size, mode="reflect")
    b = box_sum(ix * iy, block_size, mode="reflect")
    c = box_sum(iy * iy, block_size, mode="reflect")
    return ((a + c) - jnp.sqrt((a - c) ** 2 + 4.0 * b * b)) * 0.5


def good_features_to_track(
    img: jnp.ndarray,
    params: FeatureParams = FeatureParams(),
    mask: jnp.ndarray | None = None,
) -> Corners:
    """Detect up to max_corners Shi-Tomasi corners.

    img: (H, W) grayscale in [0, 255]. mask: optional (H, W) bool/0-255
    array — corners only where nonzero (SparseOF.py:61-69 masks away live
    tracks)."""
    h, w = img.shape
    eig = min_eig_map(img, params.block_size)
    if mask is not None:
        eig = jnp.where(mask != 0, eig, 0.0)
    max_val = jnp.max(eig)
    thresh = max_val * params.quality_level
    eig = jnp.where(eig >= thresh, eig, 0.0)

    # 3x3 non-max suppression; exclude the 1-pixel frame border
    dil = lax.reduce_window(
        eig, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME"
    )
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    border_ok = (xs >= 1) & (xs < w - 1) & (ys >= 1) & (ys < h - 1)
    cand = jnp.where((eig > 0) & (eig == dil) & border_ok, eig, 0.0)

    k = min(params.max_candidates, h * w)
    # the k strongest by a stable sort (ties in index order, as top_k):
    # one lax.top_k over a whole 1080p frame (2M elements) makes XLA's GPU
    # compiler exhaust host memory (PERF.md)
    flat = cand.reshape(-1)
    neg, order = lax.sort(
        (-flat, lax.iota(jnp.int32, flat.shape[0])), num_keys=1, is_stable=True
    )
    vals, idx = -neg[:k], order[:k]
    cx = (idx % w).astype(jnp.float32)
    cy = (idx // w).astype(jnp.float32)
    cand_ok = vals > 0

    min_d2 = jnp.float32(params.min_distance**2)
    max_c = params.max_corners

    def body(i, carry):
        sel, valid, count = carry
        p = jnp.array([cx[i], cy[i]])
        d2 = jnp.sum((sel - p[None, :]) ** 2, axis=-1)
        far = jnp.all(jnp.where(valid, d2 >= min_d2, True))
        take = cand_ok[i] & far & (count < max_c)
        slot = jnp.clip(count, 0, max_c - 1)
        sel = jnp.where(take, sel.at[slot].set(p), sel)
        valid = jnp.where(take, valid.at[slot].set(True), valid)
        count = count + take.astype(jnp.int32)
        return sel, valid, count

    sel0 = jnp.zeros((max_c, 2), jnp.float32)
    valid0 = jnp.zeros((max_c,), bool)
    sel, valid, count = lax.fori_loop(0, k, body, (sel0, valid0, jnp.int32(0)))
    return Corners(pts=sel, valid=valid, count=count)
