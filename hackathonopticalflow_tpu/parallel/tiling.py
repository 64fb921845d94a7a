"""Spatially tiled dense flow over a device mesh (SURVEY.md §5.7a).

Design: **recompute-in-halo**. Each device owns a contiguous row block of
the frame; one ppermute round per frame extends every block with `halo`
rows from its neighbors, after which the full Farneback pyramid runs
independently per device on the extended slab — zero communication inside
the iteration loops (one collective per frame, compute never waits on
it). The core rows of each slab are exact as long as `halo` covers the
algorithm's receptive field:

    RF ~= sum over levels of (smooth_ksize/2 + poly_n + win/2) / scale
          + max vertical displacement per level

With the reference config (4 layers at 1080p), halo=96 covers flows up to
~30 px; raise it for wilder motion. Rows within `halo` of the true frame
top/bottom differ slightly from the single-device result (the per-slab
border handling and OpenCV's 5-px border down-weighting band anchor to
slab edges there); everywhere else the match is bitwise-exact — asserted
by tests/test_parallel.py on an 8-device CPU mesh.

Pyramid alignment: Farneback resamples every level from the full-res
frame, so a slab reproduces the global level grids only if it starts on,
and spans, a multiple of the coarsest level's stride (8 rows for the
reference's 3 levels at scale 0.5). Tiles need not be aligned (1080 rows
over 4 tiles are 270-row tiles): each tile exchanges two strides more
than `halo` and cuts its slab at the aligned row at or above its first
halo row (`_slab_flow`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.config import FarnebackParams
from ..ops.farneback import farneback
from .halo import halo_exchange_rows


def derive_halo(
    params: FarnebackParams = FarnebackParams(), max_displacement: float = 30.0
) -> int:
    """Halo rows needed for the recompute-in-halo scheme to reproduce the
    single-device flow in every core row, derived from the algorithm's
    receptive field at the COARSEST level (the finest-grained reads are
    the widest in full-resolution pixels):

        (win//2 + poly_n + 2) / s_min + max_displacement

    where s_min = pyr_scale^levels: one flow-smoothing window plus the
    polynomial-expansion taps at the coarsest level (where each level
    pixel spans 1/s_min full-res rows), plus the worst-case displaced
    coefficient read. Repeated iterations and cross-level seeding are
    NOT multiplied in: the box filters average (boundary error decays
    with distance rather than propagating at full strength), and the
    coarse flow seeds the finer level only within the bilinear resize
    neighborhood — validated by tests/test_parallel.py's 3-level
    large-frame tiled-vs-single check; the deliberately-too-small-halo
    test shows the failure signature when this is violated."""
    s_min = params.pyr_scale**params.levels
    rf = (params.win_size // 2 + params.poly_n + 2) / s_min + max_displacement
    return int(-(-rf // 2) * 2)  # round up to even (pyramid grid alignment)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    axis: str = "tile"
    halo: int = 96

    @classmethod
    def for_params(
        cls,
        params: FarnebackParams = FarnebackParams(),
        max_displacement: float = 30.0,
        axis: str = "tile",
    ) -> "TileConfig":
        return cls(axis=axis, halo=derive_halo(params, max_displacement))


def _level_stride(params: FarnebackParams) -> int:
    """Rows of the full-res frame per row of the coarsest level, where
    that is an integer (1 otherwise: no alignment possible)."""
    a = 1.0 / params.pyr_scale**params.levels
    return int(round(a)) if abs(a - round(a)) < 1e-9 else 1


def _slab_rows(ht: int, params: FarnebackParams, tile: "TileConfig"):
    """(rows exchanged with each neighbour, slab height) for ht-row tiles."""
    a = _level_stride(params)
    if ht % a == 0 and tile.halo % a == 0:
        # tile edges and halo already fall on the coarsest grid
        return tile.halo, ht + 2 * tile.halo
    return tile.halo + 2 * a, -(-(ht + 2 * tile.halo + a - 1) // a) * a


def _slab_flow(
    p: jnp.ndarray, x: jnp.ndarray, params: FarnebackParams, tile: "TileConfig"
) -> jnp.ndarray:
    """Flow of this device's (H_tile, W) row block, computed on a halo
    slab whose start and height are multiples of the coarsest level's
    stride `a`, so every level's resampling grid is the global one."""
    ht = p.shape[0]
    a = _level_stride(params)
    hx, hs = _slab_rows(ht, params, tile)
    idx = lax.axis_index(tile.axis)
    first = idx * ht - tile.halo  # global row of the first halo row
    g0 = jnp.floor_divide(first, a) * a  # aligned slab start, <= first
    p_ext = halo_exchange_rows(p, hx, tile.axis, mode="edge")
    x_ext = halo_exchange_rows(x, hx, tile.axis, mode="edge")
    off = g0 - (idx * ht - hx)  # slab start inside the exchanged block
    flow = farneback(
        lax.dynamic_slice_in_dim(p_ext, off, hs, 0),
        lax.dynamic_slice_in_dim(x_ext, off, hs, 0),
        params,
    )
    return lax.dynamic_slice_in_dim(flow, idx * ht - g0, ht, 0)


def tiled_farneback(
    prev: jnp.ndarray,
    nxt: jnp.ndarray,
    mesh: Mesh,
    params: FarnebackParams = FarnebackParams(),
    tile: TileConfig = TileConfig(),
) -> jnp.ndarray:
    """Dense flow over (H, W) frames row-sharded across mesh axis
    `tile.axis`. Returns (H, W, 2) with the same sharding.

    H must be divisible by the tile axis size, and each tile must hold
    its exchanged halo (halo + 2 strides of the coarsest level).
    """
    _check_tiles(prev.shape[0], mesh.shape[tile.axis], params, tile)

    def local(p, x):
        return _slab_flow(p, x, params, tile)

    spec = P(tile.axis, None)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=P(tile.axis, None, None),
    )(prev, nxt)


def tiled_farneback_multi(
    prev: jnp.ndarray,
    nxt: jnp.ndarray,
    mesh: Mesh,
    params: FarnebackParams = FarnebackParams(),
    tile: TileConfig = TileConfig(),
    stream_axis: str = "stream",
) -> jnp.ndarray:
    """Stream-batched + row-tiled dense flow: (B, H, W) frames sharded
    (stream, tile) over a 2-D mesh — the single-host multi-stream
    configuration."""
    _check_tiles(prev.shape[1], mesh.shape[tile.axis], params, tile)

    def local(p, x):
        # p, x: (B_local, H_tile, W)
        return jax.vmap(lambda pp, xx: _slab_flow(pp, xx, params, tile))(p, x)

    spec = P(stream_axis, tile.axis, None)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=P(stream_axis, tile.axis, None, None),
    )(prev, nxt)


def _check_tiles(h: int, n: int, params: FarnebackParams, tile: TileConfig) -> None:
    if h % n:
        raise ValueError(f"H={h} not divisible by {n} tiles")
    hx, _ = _slab_rows(h // n, params, tile)
    if hx > h // n:
        raise ValueError(
            f"halo {tile.halo} + {hx - tile.halo} alignment rows exceeds "
            f"the {h // n}-row tile"
        )
