"""Robust reduction statistics.

The reference filters flow vectors with full-frame median / 99th-percentile
reductions (pathfinder_viewer.py:173, DenseOF.py:228) and computes 256-bin
histograms (Operations.py:218). These are the single-device versions; the
distributed (tiled) counterparts live in parallel/quantile.py.
"""

from __future__ import annotations

import jax.numpy as jnp


def median(x: jnp.ndarray) -> jnp.ndarray:
    """np.median parity (average of middle pair for even N)."""
    return jnp.median(x)


def percentile(x: jnp.ndarray, q: float) -> jnp.ndarray:
    """np.percentile parity (linear interpolation)."""
    return jnp.percentile(x, q)


def masked_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median over elements where mask is True (static shape; sorts with
    +inf padding). Needed because jit pipelines carry fixed-size point sets
    with validity masks instead of ragged arrays."""
    n = jnp.sum(mask)
    vals = jnp.sort(jnp.where(mask, x, jnp.inf))
    hi = jnp.clip((n // 2).astype(jnp.int32), 0, x.shape[0] - 1)
    lo = jnp.clip(hi - (1 - n % 2), 0, x.shape[0] - 1)
    return 0.5 * (vals[lo] + vals[hi])


def masked_percentile(x: jnp.ndarray, mask: jnp.ndarray, q: float) -> jnp.ndarray:
    """np.percentile(x[mask], q) with static shapes."""
    n = jnp.sum(mask)
    vals = jnp.sort(jnp.where(mask, x, jnp.inf))
    pos = (q / 100.0) * (n - 1).astype(jnp.float32)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, x.shape[0] - 1)
    hi = jnp.clip(lo + 1, 0, x.shape[0] - 1)
    frac = pos - lo.astype(jnp.float32)
    take_hi = jnp.where(hi < n, vals[hi], vals[jnp.clip(n - 1, 0, x.shape[0] - 1)])
    return vals[lo] * (1 - frac) + take_hi * frac


def histogram256(x: jnp.ndarray) -> jnp.ndarray:
    """cv2.calcHist parity for uint8 data: 256 bins over [0, 256)."""
    xi = jnp.clip(x.astype(jnp.int32), 0, 255).reshape(-1)
    return jnp.zeros((256,), jnp.int32).at[xi].add(1)


def kmeans(
    samples: jnp.ndarray,
    k: int,
    iters: int = 10,
    init_centers: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Lloyd k-means over (N, D) samples -> (compactness, labels, centers).

    Jittable stand-in for cv2.kmeans (the reference's disabled color-
    quantization experiment, DenseOF.py:326-345): the assignment step is
    one (N, K) distance matrix (batched matmul-friendly), the update step
    a masked segment mean; the whole loop is a lax.fori_loop under jit.
    Deterministic: centers default to evenly-spaced sorted samples
    (KMEANS_PP/RANDOM seeds are replaced by explicit init for
    reproducibility on device). Empty clusters keep their center.
    """
    from jax import lax

    samples = samples.astype(jnp.float32)
    n = samples.shape[0]
    if samples.ndim == 1:
        samples = samples[:, None]
    if init_centers is None:
        order = jnp.argsort(samples[:, 0])
        idx = (jnp.arange(k) * (n // k) + (n // k) // 2).astype(jnp.int32)
        centers = samples[order[idx]]
    else:
        centers = init_centers.astype(jnp.float32)

    def assign(c):
        d2 = jnp.sum((samples[:, None, :] - c[None]) ** 2, axis=-1)  # (N,K)
        return jnp.argmin(d2, axis=1), jnp.min(d2, axis=1)

    def body(_, c):
        labels, _ = assign(c)
        onehot = (labels[:, None] == jnp.arange(k)[None]).astype(jnp.float32)
        counts = onehot.sum(axis=0)  # (K,)
        sums = onehot.T @ samples  # (K, D)
        return jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), c
        )

    centers = lax.fori_loop(0, iters, body, centers)
    labels, d2 = assign(centers)
    return jnp.sum(d2), labels, centers
