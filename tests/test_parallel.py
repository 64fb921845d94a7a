"""Distributed-path tests on the 8-virtual-device CPU mesh
(SURVEY.md §4: multi-device simulation via xla_force_host_platform_device_count)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from hackathonopticalflow_tpu.core.config import FarnebackParams
from hackathonopticalflow_tpu.ops.farneback import farneback
from hackathonopticalflow_tpu.parallel.mesh import make_mesh, stream_tile_mesh
from hackathonopticalflow_tpu.parallel.halo import halo_exchange_rows
from hackathonopticalflow_tpu.parallel.quantile import (
    distributed_median,
    distributed_percentile,
    psum_histogram_quantile,
)
from hackathonopticalflow_tpu.parallel.tiling import TileConfig, tiled_farneback
from hackathonopticalflow_tpu.parallel.streams import stream_batched_farneback

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@needs_8
def test_halo_exchange_matches_padding():
    """Halo-extended tiles must reproduce slices of the edge-padded global
    array."""
    mesh = make_mesh((4,), ("tile",))
    x = np.arange(64 * 6, dtype=np.float32).reshape(64, 6)
    halo = 4

    f = shard_map(
        lambda t: halo_exchange_rows(t, halo, "tile", mode="edge"),
        mesh=mesh,
        in_specs=P("tile", None),
        out_specs=P("tile", None),
    )
    out = np.asarray(f(jnp.asarray(x)))  # (4 * (16 + 2*halo), 6) stacked
    padded = np.pad(x, ((halo, halo), (0, 0)), mode="edge")
    tile_h = 16
    for i in range(4):
        got = out[i * (tile_h + 2 * halo) : (i + 1) * (tile_h + 2 * halo)]
        want = padded[i * tile_h : i * tile_h + tile_h + 2 * halo]
        np.testing.assert_array_equal(got, want, err_msg=f"tile {i}")


@needs_8
def test_distributed_quantiles_match_numpy():
    mesh = make_mesh((8,), ("tile",))
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 40, (8, 64)).astype(np.float32)

    med = shard_map(
        lambda t: distributed_median(t.ravel(), "tile")[None],
        mesh=mesh, in_specs=P("tile", None), out_specs=P("tile"),
    )(jnp.asarray(x))
    assert abs(float(np.asarray(med)[0]) - np.median(x)) < 1e-4

    p99 = shard_map(
        lambda t: distributed_percentile(t.ravel(), 99, "tile")[None],
        mesh=mesh, in_specs=P("tile", None), out_specs=P("tile"),
    )(jnp.asarray(x))
    assert abs(float(np.asarray(p99)[0]) - np.percentile(x, 99)) < 1e-3

    approx = shard_map(
        lambda t: psum_histogram_quantile(t, 50.0, "tile", 0.0, 40.0, bins=4096)[None],
        mesh=mesh, in_specs=P("tile", None), out_specs=P("tile"),
    )(jnp.asarray(x))
    # histogram quantile is exact up to sample rank (bin width << spacing):
    # the returned value's rank must be the median rank +-1
    v = float(np.asarray(approx)[0])
    rank = (x.ravel() <= v).sum()
    assert abs(rank - x.size / 2) <= 1


@needs_8
def test_tiled_farneback_matches_single_device(frame_pair_small):
    """Tile-partitioned dense flow with halo exchange must equal the
    single-device kernel away from the true frame borders (SURVEY.md §4
    'bitwise-equal' distributed test, modulo the documented border band)."""
    a, b = frame_pair_small  # (270, 480)
    a = a[:256].astype(np.float32)
    b = b[:256].astype(np.float32)
    params = FarnebackParams(levels=1)
    halo = 64
    mesh = make_mesh((4,), ("tile",))
    single = np.asarray(farneback(jnp.asarray(a), jnp.asarray(b), params))
    tiled = np.asarray(
        jax.jit(
            lambda p, x: tiled_farneback(
                p, x, mesh, params, TileConfig(halo=halo)
            )
        )(jnp.asarray(a), jnp.asarray(b))
    )
    assert tiled.shape == single.shape
    core = np.s_[halo:-halo]
    d = np.linalg.norm(tiled[core] - single[core], axis=-1)
    assert d.max() < 1e-3, d.max()


@needs_8
def test_stream_batched_farneback_matches_per_stream():
    mesh = make_mesh((8,), ("stream",))
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 255, (8, 64, 96)).astype(np.float32)
    b = np.roll(a, 2, axis=-1)
    params = FarnebackParams(levels=1)
    out = np.asarray(
        jax.jit(lambda p, x: stream_batched_farneback(p, x, mesh, params))(
            jnp.asarray(a), jnp.asarray(b)
        )
    )
    ref0 = np.asarray(farneback(jnp.asarray(a[3]), jnp.asarray(b[3]), params))
    np.testing.assert_allclose(out[3], ref0, atol=0.05)  # vmap changes f32 reduction order


@needs_8
def test_stream_tile_mesh_2d():
    mesh = stream_tile_mesh(2, 4)
    assert mesh.shape == {"stream": 2, "tile": 4}


def test_derive_halo_reference_config():
    from hackathonopticalflow_tpu.parallel.tiling import derive_halo

    h = derive_halo(FarnebackParams(), max_displacement=30.0)
    assert h % 2 == 0 and 100 <= h <= 200
    # coarser pyramids need more full-res halo; bigger motion needs more
    assert derive_halo(FarnebackParams(levels=1)) < h
    assert derive_halo(FarnebackParams(), max_displacement=100.0) > h


@needs_8
def test_tiled_farneback_3level_large_frame():
    """The REAL reference configuration (3 levels) at a large frame with
    strong synthetic motion: the derived halo must reproduce the
    single-device flow in every core row (VERDICT round-1 item 6 — the
    round-1 test only covered a 1-level toy config)."""
    from hackathonopticalflow_tpu.ops.image import sep_conv2d
    from hackathonopticalflow_tpu.parallel.tiling import derive_halo

    rng = np.random.RandomState(0)
    h, w, shift = 1024, 256, 22
    base = rng.uniform(0, 255, (h + 64, w + 64)).astype(np.float32)
    k = jnp.asarray([0.25, 0.5, 0.25])
    for _ in range(3):
        base = np.asarray(sep_conv2d(jnp.asarray(base), k, k))
    a = base[32 : 32 + h, 32 : 32 + w]
    b = base[32 - shift : 32 - shift + h, 32 : 32 + w]  # 22 px vertical flow
    params = FarnebackParams()  # 3 levels, the reference config
    halo = derive_halo(params, max_displacement=float(shift + 8))
    mesh = make_mesh((4,), ("tile",))
    single = np.asarray(farneback(jnp.asarray(a), jnp.asarray(b), params))
    tiled = np.asarray(
        jax.jit(
            lambda p, x: tiled_farneback(p, x, mesh, params, TileConfig(halo=halo))
        )(jnp.asarray(a), jnp.asarray(b))
    )
    core = np.s_[halo:-halo]
    d = np.linalg.norm(tiled[core] - single[core], axis=-1)
    # residual seam error decays through the box filters but is not zero
    # at 3 levels; the budget reference is BASELINE.json's 0.5 px EPE
    assert d.max() < 0.1, d.max()
    assert d.mean() < 1e-3, d.mean()
    # sanity: the flow itself is the expected large motion
    assert abs(np.median(single[core][..., 1]) - shift) < 1.0


@needs_8
def test_tiled_farneback_too_small_halo_fails():
    """Failure signature: with a quarter of the derived halo, core rows
    near tile seams must deviate visibly — documents what an inadequate
    halo looks like (VERDICT round-1 item 6)."""
    from hackathonopticalflow_tpu.ops.image import sep_conv2d
    from hackathonopticalflow_tpu.parallel.tiling import derive_halo

    rng = np.random.RandomState(1)
    h, w, shift = 1024, 256, 22
    base = rng.uniform(0, 255, (h + 64, w + 64)).astype(np.float32)
    k = jnp.asarray([0.25, 0.5, 0.25])
    for _ in range(3):
        base = np.asarray(sep_conv2d(jnp.asarray(base), k, k))
    a = base[32 : 32 + h, 32 : 32 + w]
    b = base[32 - shift : 32 - shift + h, 32 : 32 + w]
    params = FarnebackParams()
    halo_ok = derive_halo(params, max_displacement=float(shift + 8))
    halo_bad = 2  # essentially no halo: seams must show
    mesh = make_mesh((4,), ("tile",))
    single = np.asarray(farneback(jnp.asarray(a), jnp.asarray(b), params))
    tiled = np.asarray(
        jax.jit(
            lambda p, x: tiled_farneback(p, x, mesh, params, TileConfig(halo=halo_bad))
        )(jnp.asarray(a), jnp.asarray(b))
    )
    core = np.s_[halo_ok:-halo_ok]
    d = np.linalg.norm(tiled[core] - single[core], axis=-1)
    assert d.max() > 0.5, (
        "expected visible seam error with a 4x-too-small halo; the "
        f"derived halo may be overly conservative (max diff {d.max()})"
    )


@needs_8
def test_tiled_farneback_unaligned_tiles():
    """Tiles whose height is not a multiple of the coarsest level's
    stride (260 rows; 8 at 3 levels — as 1080 rows over 4 tiles give 270)
    still resample the global pyramid grid: each slab is cut at an aligned
    row, so core rows match the single device under a 22 px flow. (Slabs
    cut at the tile edges read max 0.12 px / mean 5.6e-4 px here.)"""
    from hackathonopticalflow_tpu.io.synthetic import textured_frame
    from hackathonopticalflow_tpu.parallel.tiling import derive_halo

    base = textured_frame(1100, 100, seed=4)
    a = base[30:1070, 10:74]
    b = base[8:1048, 10:74]  # 22 px vertical flow
    params = FarnebackParams()
    halo = derive_halo(params, max_displacement=30.0)
    mesh = make_mesh((4,), ("tile",))
    single = np.asarray(farneback(jnp.asarray(a), jnp.asarray(b), params))
    tiled = np.asarray(
        jax.jit(
            lambda p, x: tiled_farneback(p, x, mesh, params, TileConfig(halo=halo))
        )(jnp.asarray(a), jnp.asarray(b))
    )
    core = np.s_[halo:-halo]
    d = np.linalg.norm(tiled[core] - single[core], axis=-1)
    assert d.max() < 0.05, d.max()
    assert d.mean() < 1e-4, d.mean()
