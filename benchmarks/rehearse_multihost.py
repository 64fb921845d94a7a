"""2-process jax.distributed rehearsal on localhost.

The PROCESS-SPANNING mesh semantics of `parallel/mesh.py init_multihost`
— jax.distributed.initialize, a global mesh whose axis crosses process
boundaries, collectives riding the distributed runtime (Gloo on CPU; the
same program text runs over NCCL between GPU hosts) — are fully
rehearsable with two localhost processes.

Launcher mode (no args): spawns itself twice (process_id 0/1, each with
4 virtual CPU devices -> an 8-device global mesh), waits, and prints a
one-line verdict. Worker mode (--pid N --port P) runs the checks:

1. init_multihost brings up the runtime; jax.device_count() == 8 with
   jax.local_device_count() == 4 on each process.
2. host_local_streams partitions a 4-video list disjointly/completely.
3. Tiled dense Farneback (parallel/tiling.py) over a ('tile',) axis of
   all 8 devices — halo exchange ppermutes cross the process boundary —
   asserted equal (<=2e-3 px away from frame borders, the
   tests/test_parallel.py bound) to the local single-device flow that
   each process computes independently.
4. Distributed windowed BA (parallel/ba_dist.py, landmark shard over all
   8 devices) asserted equal to the local single-device bundle_adjust
   (rvec/tvec atol 1e-4, the tests/test_pose_ba.py bound).
5. Distributed median/P99 + psum-histogram quantile (parallel/quantile.py)
   over values sharded across both processes, asserted vs numpy.

Each worker writes rehearse_multihost_ok_<pid> to the system temporary
directory (ok_path) on success.

Reference: SURVEY.md §5.8 (multi-host = jax.distributed.initialize +
the same collectives spanning hosts).
"""

from __future__ import annotations

import os
import sys
import tempfile

PORT_DEFAULT = 29417


def ok_path(pid: int) -> str:
    return os.path.join(tempfile.gettempdir(), f"rehearse_multihost_ok_{pid}")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def worker(pid: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from hackathonopticalflow_tpu.parallel.mesh import (
        host_local_streams,
        init_multihost,
    )

    init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid)

    import numpy as np
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    # 1. runtime shape
    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()
    assert jax.device_count() == 8, jax.device_count()
    log(f"[pid {pid}] runtime up: 2 processes x 4 devices")

    # 2. host-local data partitioning
    paths = [f"clip{i}.mp4" for i in range(4)]
    mine = host_local_streams(paths)
    assert len(mine) == 2 and all(
        int(p[4]) % 2 == pid for p in mine
    ), (pid, mine)

    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("tile",))

    def sharded(arr, spec):
        ns = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, ns, lambda idx: arr[idx]
        )

    # 3. tiled dense flow with halo exchange across the process boundary
    from hackathonopticalflow_tpu.core.config import FarnebackParams
    from hackathonopticalflow_tpu.ops.farneback import farneback
    from hackathonopticalflow_tpu.parallel.tiling import (
        TileConfig,
        tiled_farneback,
    )

    from hackathonopticalflow_tpu.ops.image import sep_conv2d

    rng = np.random.RandomState(0)
    h, w = 768, 256  # 96-row tiles over 8 devices (> the 48-row halo)
    base = rng.uniform(0, 255, (h + 16, w + 16)).astype(np.float32)
    k5 = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for _ in range(3):  # smooth texture: well-conditioned Farneback input
        base = np.asarray(sep_conv2d(jnp.asarray(base), k5, k5))
    prev = base[4 : 4 + h, 4 : 4 + w]
    nxt = base[7 : 7 + h, 6 : 6 + w]
    params = FarnebackParams(levels=2)
    halo = 48
    tile = TileConfig(halo=halo)
    flow_t = jax.jit(
        lambda p, x: tiled_farneback(p, x, mesh, params, tile),
        static_argnums=(),
    )(sharded(prev, P("tile", None)), sharded(nxt, P("tile", None)))
    # replicate for comparison: every process checks its full copy
    from jax.experimental import multihost_utils

    flow_full = multihost_utils.process_allgather(flow_t, tiled=True)
    ref = np.asarray(farneback(jnp.asarray(prev), jnp.asarray(nxt), params))
    # same acceptance as tests/test_parallel.py: core region (one halo
    # away from the frame borders) matches the single-device flow
    d = np.linalg.norm(np.asarray(flow_full) - ref, axis=-1)[halo:-halo]
    assert d.max() < 2e-3, d.max()
    log(f"[pid {pid}] tiled dense flow == single device (max {d.max():.1e})")

    # 4. distributed BA, landmarks sharded over both processes
    from hackathonopticalflow_tpu.nav.ba import (
        BAState,
        bundle_adjust,
        rodrigues,
    )
    from hackathonopticalflow_tpu.parallel.ba_dist import (
        distributed_bundle_adjust,
    )

    m, l = 5, 96
    steps = rng.normal([0, 0, 0.4], 0.05, (m - 1, 3))
    cs = np.concatenate([[np.zeros(3)], np.cumsum(steps, 0)])
    angs = np.cumsum(rng.normal(0, 0.02, (m, 3)), 0)
    angs[0] = 0
    rs = np.stack(
        [np.asarray(rodrigues(jnp.asarray(a, jnp.float32))) for a in angs]
    )
    x3 = rng.uniform([-3, -2, 4], [3, 2, 12], (l, 3))
    obs = np.zeros((m, l, 2), np.float32)
    for k in range(m):
        pc = (rs[k] @ (x3 - cs[k]).T).T
        obs[k] = pc[:, :2] / pc[:, 2:3]
    obs += rng.normal(0, 5e-4, obs.shape).astype(np.float32)
    tv = np.stack([-(rs[k] @ cs[k]) for k in range(m)]).astype(np.float32)
    rv = np.stack(
        [
            np.asarray(
                __import__(
                    "hackathonopticalflow_tpu.nav.ba", fromlist=["so3_log"]
                ).so3_log(jnp.asarray(r))
            )
            for r in rs
        ]
    ).astype(np.float32)
    rv_n = rv + rng.normal(0, 5e-3, rv.shape).astype(np.float32)
    tv_n = tv + rng.normal(0, 2e-2, tv.shape).astype(np.float32)
    pts_n = (x3 + rng.normal(0, 5e-2, x3.shape)).astype(np.float32)
    mask = np.ones((m, l), bool)

    state_local = BAState(
        rvecs=jnp.asarray(rv_n),
        tvecs=jnp.asarray(tv_n),
        points=jnp.asarray(pts_n),
        obs=jnp.asarray(obs),
        mask=jnp.asarray(mask),
    )
    ref_out, ref_stats = jax.jit(
        lambda s: bundle_adjust(s, iters=8, lam=1e-4)
    )(state_local)

    state_dist = BAState(
        rvecs=sharded(rv_n, P()),
        tvecs=sharded(tv_n, P()),
        points=sharded(pts_n, P("tile", None)),
        obs=sharded(obs, P(None, "tile", None)),
        mask=sharded(mask, P(None, "tile")),
    )
    dist_out, dist_stats = distributed_bundle_adjust(
        state_dist, mesh, axis_name="tile", iters=8, lam=1e-4
    )
    def local_copy(arr):
        # replicated output: every device holds the full value — read the
        # process-local shard, no cross-host fetch needed
        return np.asarray(arr.addressable_shards[0].data)

    drv = local_copy(dist_out.rvecs)
    dtv = local_copy(dist_out.tvecs)
    assert np.abs(drv - np.asarray(ref_out.rvecs)).max() < 1e-4
    assert np.abs(dtv - np.asarray(ref_out.tvecs)).max() < 1e-4
    log(
        f"[pid {pid}] distributed BA == single device "
        f"(cost {float(dist_stats.cost):.3e} vs {float(ref_stats.cost):.3e})"
    )

    # 5. distributed robust statistics across the process boundary
    from hackathonopticalflow_tpu.parallel.quantile import (
        distributed_median,
        distributed_percentile,
        psum_histogram_quantile,
    )

    vals = rng.uniform(0, 100, (8, 512)).astype(np.float32)

    def stats_local(x):
        return (
            distributed_median(x, "tile"),
            distributed_percentile(x, 99.0, "tile"),
            psum_histogram_quantile(x, 99.0, "tile", 0.0, 100.0),
        )

    med, p99, p99h = jax.jit(
        shard_map(
            stats_local,
            mesh=mesh,
            in_specs=P("tile", None),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )(sharded(vals, P("tile", None)))
    med = float(local_copy(med))
    p99 = float(local_copy(p99))
    p99h = float(local_copy(p99h))
    assert abs(med - float(np.median(vals))) < 1e-3, (med, np.median(vals))
    assert abs(p99 - float(np.percentile(vals, 99))) < 1e-3
    assert abs(p99h - float(np.percentile(vals, 99))) < 0.1  # bin width
    log(f"[pid {pid}] distributed quantiles == numpy")

    with open(ok_path(pid), "w") as f:
        f.write("ok\n")
    log(f"[pid {pid}] ALL CHECKS PASSED")


def launch(port: int = PORT_DEFAULT) -> int:
    import subprocess

    for pid in (0, 1):
        p = ok_path(pid)
        if os.path.exists(p):
            os.unlink(p)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--pid", str(pid),
             "--port", str(port)],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in (0, 1)
    ]
    rcs = [p.wait(timeout=600) for p in procs]
    ok = all(rc == 0 for rc in rcs) and all(
        os.path.exists(ok_path(pid)) for pid in (0, 1)
    )
    print(
        "REHEARSAL "
        + ("PASSED" if ok else f"FAILED (rcs {rcs})")
        + ": 2-process jax.distributed mesh, tiled flow + BA + quantiles"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--port", type=int, default=PORT_DEFAULT)
    args = ap.parse_args()
    if args.pid is None:
        sys.exit(launch(args.port))
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    worker(args.pid, args.port)
