"""Multi-device scaling curve: stream-batched dense flow throughput at
1, 2, 4, 8 devices. Emits one JSON line per point to stdout.

    python benchmarks/bench_scaling.py           # 8 virtual CPU devices
    python benchmarks/bench_scaling.py --real    # the machine's GPUs

On the virtual CPU mesh this measures SPMD correctness/overhead, not
speed; with --real the same code path runs on the attached GPUs."""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    real = "--real" in sys.argv[1:]
    if not real:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
    import jax

    if not real:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hackathonopticalflow_tpu.core.config import FarnebackParams
    from hackathonopticalflow_tpu.parallel.mesh import make_mesh
    from hackathonopticalflow_tpu.parallel.streams import stream_batched_farneback

    h, w = 144, 192  # small so CPU SPMD runs are quick
    params = FarnebackParams(levels=1)
    rng = np.random.RandomState(0)
    n_dev_avail = len(jax.devices())
    for n in [1, 2, 4, 8]:
        if n > n_dev_avail:
            break
        mesh = make_mesh((n,), ("stream",))
        b = n * 2
        a = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
        bb = np.roll(a, 2, axis=-1)
        sh = NamedSharding(mesh, P("stream", None, None))
        da = jax.device_put(jnp.asarray(a), sh)
        db = jax.device_put(jnp.asarray(bb), sh)
        fn = jax.jit(
            lambda p, x: jnp.sum(jnp.abs(stream_batched_farneback(p, x, mesh, params)))
        )
        _ = float(fn(da, db))
        times = []
        for _i in range(3):
            t0 = time.perf_counter()
            _ = float(fn(da, db))
            times.append(time.perf_counter() - t0)
        fps = b / min(times)
        print(
            json.dumps(
                {
                    "metric": f"stream_dp_fps_{n}dev",
                    "value": round(fps, 2),
                    "unit": "frames/s",
                    "vs_baseline": None,
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
