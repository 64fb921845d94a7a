"""Device-mesh construction.

The reference is strictly single-process (SURVEY.md §2.4); all parallelism
here comes from the project north star: stream data-parallelism (batch of
videos), spatial tiling of dense flow, and distributed windowed BA. The
mesh axes are:

- 'stream': independent video streams (pure DP — frame t depends on t-1
  within a stream, so time is sequential per stream);
- 'tile':   spatial row-tiles of one frame (halo-exchange domain);

The mesh is a plain grid over the device list: on one GPU host every card
reaches every other over NVLink at the same rate, so the axes follow the
algorithm alone. Multi-host extends the same axes via jax.distributed (the
mesh is constructed from the global device list; XLA hands the
collectives to NCCL).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev, axis_names)


def stream_tile_mesh(n_streams: int, n_tiles: int, devices=None) -> Mesh:
    """('stream', 'tile') mesh — the standard layout for batched tiled flow."""
    return make_mesh((n_streams, n_tiles), ("stream", "tile"), devices)


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Bring up the jax distributed runtime for multi-host runs.

    After this, jax.devices() spans every host and the same mesh/
    shard_map code paths run across them — data loading should shard per
    host (each process decodes its own video subset). No-op when already
    initialized or single-process.
    """
    import jax

    if coordinator is None:
        return  # single host
    # must not touch jax.process_count()/devices() here: any backend
    # query initializes XLA and jax.distributed.initialize then refuses
    # to run (benchmarks/rehearse_multihost.py) —
    # probe the distributed client state directly instead. The probe
    # touches a private jax internal, so guard it: if the attribute path
    # moves in a future jax, fall through to initialize and catch its
    # already-initialized complaint instead.
    try:
        from jax._src import distributed as _dist

        if getattr(_dist.global_state, "client", None) is not None:
            return  # already initialized
    except Exception:
        pass
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" in str(e).lower():
            return  # initialized by someone else — the no-op contract
        raise


def host_local_streams(paths: list[str]) -> list[str]:
    """Partition a video list across hosts (round-robin by process id)."""
    import jax

    pid = jax.process_index()
    n = jax.process_count()
    return [p for i, p in enumerate(paths) if i % n == pid]
