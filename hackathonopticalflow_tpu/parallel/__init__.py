"""Device meshes, stream DP, spatial tiling + halo exchange, distributed
BA and robust statistics.

Exports resolve LAZILY (PEP 562): `init_multihost` must run before
anything initializes the XLA backend, and several submodules build jnp
constants at import time — eager re-exports here would initialize the
backend during `from ..parallel.mesh import init_multihost` and make
jax.distributed.initialize refuse to start (seen in
benchmarks/rehearse_multihost.py).
"""

_EXPORTS = {
    "make_mesh": "mesh",
    "stream_tile_mesh": "mesh",
    "init_multihost": "mesh",
    "host_local_streams": "mesh",
    "halo_exchange_rows": "halo",
    "distributed_median": "quantile",
    "distributed_percentile": "quantile",
    "psum_histogram_quantile": "quantile",
    "tiled_farneback": "tiling",
    "tiled_farneback_multi": "tiling",
    "TileConfig": "tiling",
    "stream_batched_grid_flow": "streams",
    "stream_batched_farneback": "streams",
    "distributed_bundle_adjust": "ba_dist",
    "ring_bundle_adjust": "ba_ring",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
