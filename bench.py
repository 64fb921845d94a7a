"""Benchmark: dense Farneback flow at 720p on one device vs OpenCV's
calcOpticalFlowFarneback on this host's CPU.

Prints exactly ONE JSON line to stdout:
    {"metric": "dense_flow_fps_720p", "value": N,
     "unit": "frames/s/chip", "vs_baseline": N / cpu_fps}

Method:
- frames: the seeded synthetic clip (hackathonopticalflow_tpu/io/
  synthetic.py — expansion about an off-centre FOE, drift, two discs
  moving > 40 px per frame at 1080p), the same frames the tests and
  chip_smoke.py use;
- CPU baseline: cv2.calcOpticalFlowFarneback with the reference's
  parameters (DenseOF.py:127-157) per frame pair, where cv2 is installed
  (vs_baseline is null otherwise);
- device: frames staged on device once, one jitted lax.scan over all
  pairs with FarnebackParams() (the exact coefficient warp);
  steady-state time over repeated scans.

The sparse pathfinder pipeline (1080p, grid 30) runs as a secondary
number on stderr; a failure there fails the benchmark. stdout stays
machine-readable.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_frames(n_pairs: int, h: int, w: int) -> np.ndarray:
    """(n_pairs+1, h, w) uint8 gray frames of the seeded clip."""
    from hackathonopticalflow_tpu.io.synthetic import seeded_clip

    return seeded_clip(n_pairs + 1, h, w, seed=0)


def steady_fps(run, arg, n_pairs, reps=3, label=""):
    t0 = time.perf_counter()
    _ = float(run(arg))
    log(f"{label}: compile+first {time.perf_counter() - t0:.1f}s")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _ = float(run(arg))
        times.append(time.perf_counter() - t0)
    fps = n_pairs / min(times)
    log(f"{label}: {min(times):.3f}s / {n_pairs} pairs -> {fps:.2f} fps  {times}")
    return fps


def cpu_fps_protocol(step, n, rounds=7, label=""):
    """CPU-baseline protocol: median of `rounds` timing rounds of n
    frame-pairs each, so one host-load spike can't halve (or double) the
    baseline. `step(i)` runs pair i's full CPU pipeline."""
    per_round = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        per_round.append(n / (time.perf_counter() - t0))
    med = sorted(per_round)[len(per_round) // 2]
    log(
        f"cpu {label}: median {med:.2f} fps over {rounds} rounds "
        f"({[round(f, 2) for f in per_round]})"
    )
    return med


def bench_dense(n_pairs: int = 24):
    """Headline: dense Farneback 720p, ours vs cv2 CPU."""
    from hackathonopticalflow_tpu.core.config import FarnebackParams
    from hackathonopticalflow_tpu.flow.dense import farneback_flow_video

    frames = load_frames(n_pairs, 720, 1280)
    cpu_fps = None
    cv2 = _cv2()
    if cv2 is not None:
        n = min(4, n_pairs)
        cpu_fps = cpu_fps_protocol(
            lambda i: cv2.calcOpticalFlowFarneback(
                frames[i], frames[i + 1], None, 0.5, 3, 15, 3, 5, 1.2, 0
            ),
            n,
            label="cv2 Farneback 720p",
        )

    dev = jax.device_put(jnp.asarray(frames, jnp.float32))
    params = FarnebackParams()

    @jax.jit
    def run(fr):
        # whole-clip scan: each frame's poly pyramid is prepared ONCE
        # (flow/dense.py farneback_flow_video)
        return jnp.sum(jnp.abs(farneback_flow_video(fr, params)))

    fps = steady_fps(run, dev, n_pairs, label="dense 720p (device)")
    return fps, cpu_fps


def bench_sparse(n_pairs: int = 48):
    """Secondary: the reference's headline sparse pathfinder pipeline at
    1080p (grid LK -> radial normalize -> robust filter) vs cv2 CPU, as
    one 48-pair device-resident scan. CPU protocol: 7 rounds of 5 pairs,
    median."""
    from hackathonopticalflow_tpu.core.config import LKParams
    from hackathonopticalflow_tpu.core.grid import measurement_grid
    from hackathonopticalflow_tpu.flow.lk_grid import lk_grid_flow_video

    frames = load_frames(n_pairs, 1080, 1920)
    h, w = frames.shape[1:]
    pts_np = measurement_grid(h, w, 30)

    cpu_fps = None
    cv2 = _cv2()
    if cv2 is not None:

        def cpu_step(i):
            nxt, _s, _e = cv2.calcOpticalFlowPyrLK(
                frames[i + 1], frames[i], pts_np.reshape(-1, 1, 2), None,
                winSize=(45, 45), maxLevel=2,
                criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 10, 0.03),
            )
            fl = nxt.reshape(-1, 2) - pts_np
            m = np.linalg.norm(fl, axis=-1)
            dc = np.linalg.norm(pts_np - [w / 2, h / 2], axis=-1)
            m = m / (5 + np.sqrt(dc)) * 30
            _ = (np.median(m) < m) & (m < np.percentile(m, 99))

        cpu_fps = cpu_fps_protocol(
            cpu_step, min(5, n_pairs), label="reference sparse pipeline 1080p"
        )

    pts = jax.device_put(jnp.asarray(pts_np))
    dev = jax.device_put(jnp.asarray(frames))
    # the reference pipeline never reads LK's residual err
    lk_params = LKParams(compute_err=False)

    @jax.jit
    def run_all(fr):
        # viewer semantics are backward flow (current -> previous): feed
        # the clip reversed so each step tracks frame t into frame t-1
        res = lk_grid_flow_video(fr[::-1].astype(jnp.float32), pts, lk=lk_params)
        return jnp.sum(res.modulus)

    fps = steady_fps(run_all, dev, n_pairs, label="sparse 1080p (device)")
    return fps, cpu_fps


def _cv2():
    """cv2 for the CPU baselines, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        log("cv2 not installed: no CPU baseline")
        return None
    return cv2


def main():
    from hackathonopticalflow_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")
    dense_fps, dense_cpu = bench_dense()
    sparse_fps, sparse_cpu = bench_sparse()
    log(
        f"secondary sparse_pipeline_fps_1080p: {sparse_fps:.2f}"
        + (f" (vs_baseline {sparse_fps / sparse_cpu:.2f})" if sparse_cpu else "")
    )

    vs = dense_fps / dense_cpu if dense_cpu else None
    print(
        json.dumps(
            {
                "metric": "dense_flow_fps_720p",
                "value": round(dense_fps, 2),
                "unit": "frames/s/chip",
                "vs_baseline": round(vs, 2) if vs else None,
            }
        )
    )


if __name__ == "__main__":
    main()
