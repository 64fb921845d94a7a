"""Distributed robust statistics.

The reference's vector filter takes a full-frame median / 99th percentile
(pathfinder_viewer.py:173). Under spatial tiling those become cross-device
reductions (SURVEY.md §5.8). Two strategies:

- exact: all_gather the per-tile magnitude vectors (the grid at step 30 on
  1080p is only ~2.3k floats — one cheap transfer) and reduce locally;
- histogram: psum a fixed-width histogram and invert its CDF — O(bins)
  communication independent of N, for dense per-pixel statistics.

Both are shard_map-side functions (must run under an active mesh axis).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def distributed_median(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Exact np.median over values sharded along axis_name."""
    all_x = lax.all_gather(x, axis_name, tiled=True)
    return jnp.median(all_x)


def distributed_percentile(x: jnp.ndarray, q: float, axis_name: str) -> jnp.ndarray:
    """Exact np.percentile (linear interpolation) over sharded values."""
    all_x = lax.all_gather(x, axis_name, tiled=True)
    return jnp.percentile(all_x, q)


def psum_histogram_quantile(
    x: jnp.ndarray,
    q: float,
    axis_name: str,
    lo: float,
    hi: float,
    bins: int = 4096,
) -> jnp.ndarray:
    """Approximate quantile via a psum-reduced histogram over [lo, hi].

    Communication is O(bins) regardless of element count — the right tool
    for dense (per-pixel) magnitude statistics over tiled frames. Error is
    bounded by the bin width (hi - lo) / bins.
    """
    xc = jnp.clip(x.reshape(-1), lo, hi)
    idx = jnp.clip(((xc - lo) / (hi - lo) * bins).astype(jnp.int32), 0, bins - 1)
    hist = jnp.zeros((bins,), jnp.int32).at[idx].add(1)
    hist = lax.psum(hist, axis_name)
    cdf = jnp.cumsum(hist)
    n = cdf[-1]
    target = q / 100.0 * n.astype(jnp.float32)
    bin_idx = jnp.searchsorted(cdf.astype(jnp.float32), target)
    bin_idx = jnp.clip(bin_idx, 0, bins - 1)
    return lo + (bin_idx.astype(jnp.float32) + 0.5) * (hi - lo) / bins
