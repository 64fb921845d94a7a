"""Halo exchange over a mesh axis.

The building block for spatially tiled dense flow: each device owns a
contiguous row block of the frame and needs `halo` rows from each
neighbor to evaluate windowed operators near its block edges
(SURVEY.md §5.7a). Implemented with paired lax.ppermute shifts — two
nearest-neighbor transfers, no all-gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def halo_exchange_rows(x: jnp.ndarray, halo: int, axis_name: str, mode: str = "edge") -> jnp.ndarray:
    """Extend a per-device row block (H_tile, ...) with `halo` rows from
    each neighbor along `axis_name`.

    Boundary devices (first/last tile) pad with `mode` (edge replicate by
    default — matching the conv border the single-device kernels use at
    true frame borders).

    Must be called inside shard_map over a mesh that includes `axis_name`.
    Returns (H_tile + 2*halo, ...).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    top_strip = x[:halo]  # rows this device sends upward
    bot_strip = x[-halo:]  # rows this device sends downward

    # receive from the previous tile (their bottom rows become our top halo)
    from_prev = lax.ppermute(
        bot_strip, axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    # receive from the next tile (their top rows become our bottom halo)
    from_next = lax.ppermute(
        top_strip, axis_name, [(i, (i - 1) % n) for i in range(n)]
    )

    if mode == "edge":
        pad_top = jnp.repeat(x[:1], halo, axis=0)
        pad_bot = jnp.repeat(x[-1:], halo, axis=0)
    elif mode == "reflect":
        pad_top = x[1 : halo + 1][::-1]
        pad_bot = x[-halo - 1 : -1][::-1]
    elif mode == "constant":
        pad_top = jnp.zeros_like(x[:halo])
        pad_bot = jnp.zeros_like(x[:halo])
    else:
        raise ValueError(mode)

    top = jnp.where(idx == 0, pad_top, from_prev)
    bot = jnp.where(idx == n - 1, pad_bot, from_next)
    return jnp.concatenate([top, x, bot], axis=0)
