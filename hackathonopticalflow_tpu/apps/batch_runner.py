"""Multi-stream batched pipeline runner: several flight videos
processed concurrently, one stream per device where there are enough.

Decodes N videos in lockstep (threaded prefetchers), stacks their frames
into a (B, H, W) device batch sharded over the 'stream' mesh axis, and
runs the grid-LK danger pipeline for all streams in one dispatch per
frame step. Per-stream failure isolation: a stream whose decode ends (or
errors) is masked out while the batch keeps running (SURVEY.md §5.3).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.config import FilterParams, LKParams, NormalizeParams
from ..core.grid import measurement_grid
from ..flow.lk_grid import lk_grid_flow
from ..io.prefetch import FramePrefetcher
from ..parallel.mesh import make_mesh
from ..utils.compile_cache import enable_compile_cache
from ..utils.logging import get_logger

log = get_logger("apps.batch_runner")


@dataclasses.dataclass
class BatchRunnerConfig:
    videos: list[str]
    step: int = 30
    max_frames: int | None = None
    n_devices: int | None = None  # default: all available
    lk: LKParams = LKParams()
    norm: NormalizeParams = NormalizeParams()
    filt: FilterParams = FilterParams()
    #: checkpoint/resume for the streaming path: saves (step index,
    #: previous frame batch, alive mask) atomically every
    #: checkpoint_every steps; resumes from the file if present. The
    #: resumed per-stream output sequence is numerically identical to an
    #: uninterrupted run (tests/test_apps.py).
    checkpoint_path: str | None = None
    checkpoint_every: int = 24


def run_batch(cfg: BatchRunnerConfig) -> dict:
    b = len(cfg.videos)
    n_dev = cfg.n_devices or min(len(jax.devices()), b)
    while b % n_dev:
        n_dev -= 1
    mesh = make_mesh((n_dev,), ("stream",))
    sharding = NamedSharding(mesh, P("stream", None, None))

    import os

    from ..utils.checkpoint import load_checkpoint, save_checkpoint

    # resume: restore (step index, previous frame batch, alive mask) and
    # pick each stream's decode up where the checkpoint left it
    resume = None
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        probe = FramePrefetcher(cfg.videos[0], max_frames=1, to_device=False)
        h0, w0 = next(iter(probe)).shape
        resume = load_checkpoint(
            cfg.checkpoint_path,
            {
                "n_steps": np.int64(0),
                "prev": np.zeros((b, h0, w0), np.uint8),
                "alive": np.zeros((b,), bool),
            },
        )
        log.info("resuming at step %d", int(resume["n_steps"]))
    # Invariant (kept across ANY number of resumes): after each step,
    # `prev` holds frame index n_steps, and a checkpoint records exactly
    # that pair. On resume we therefore restart the counter AT the saved
    # n_steps (prev = frame n_steps) and decode from frame n_steps + 1;
    # restarting the counter one higher would shift every subsequent
    # checkpoint and make a second resume skip a frame (advisor r4).
    n_steps0 = 0 if resume is None else int(resume["n_steps"])
    start = 0 if resume is None else n_steps0 + 1  # first frame to decode
    remaining = None if cfg.max_frames is None else cfg.max_frames - start
    prefetchers = [
        FramePrefetcher(
            v, start_frame=start, max_frames=remaining, to_device=False
        )
        for v in cfg.videos
    ]
    iters = [iter(p) for p in prefetchers]

    if resume is None:
        first = [next(it, None) for it in iters]
        if any(f is None for f in first):
            raise IOError("a stream has no first frame")
        h, w = first[0].shape
        for f in first:
            if f.shape != (h, w):
                raise ValueError("streams must share resolution for batching")
        alive0 = np.ones(b, bool)
    else:
        first = list(np.asarray(resume["prev"]))
        h, w = first[0].shape
        alive0 = np.array(resume["alive"])  # writable copy (jnp view is RO)
    pts = jnp.asarray(measurement_grid(h, w, cfg.step))

    pair_fn = lambda a, bb: lk_grid_flow(
        a, bb, pts, lk=cfg.lk, norm=cfg.norm, filt=cfg.filt
    )
    if n_dev == b:
        # one stream per device: vmap partitions cleanly over the mesh
        fn = jax.jit(jax.vmap(pair_fn, in_axes=(0, 0)))
    else:
        # several streams per device run one after another
        fn = jax.jit(lambda aa, bb: jax.lax.map(lambda ab: pair_fn(*ab), (aa, bb)))

    # stage frames as u8 (a quarter of f32's bytes); prepare_frame casts
    # on device (u8 -> f32 is exact)
    prev = np.stack(first).astype(np.uint8)
    alive = alive0
    danger_counts = [[] for _ in range(b)]
    n_steps = n_steps0
    since_save = 0
    # compile outside the clock (methodology shared with bench.py /
    # run_batched: the recorded number is steady-state throughput), and
    # carry prev ON DEVICE so each step ships one frame batch, not two
    dev_prev = jax.device_put(jnp.asarray(prev), sharding)
    jax.block_until_ready(fn(dev_prev, dev_prev).good)
    t0 = time.time()
    while alive.any():
        cur = prev.copy()
        for i, it in enumerate(iters):
            if not alive[i]:
                continue
            nxt = next(it, None)
            if nxt is None:
                alive[i] = False  # stream ended; keep batch shape, mask results
                log.info("stream %d ended at step %d", i, n_steps)
            else:
                cur[i] = nxt
        if not alive.any():
            break
        dev_cur = jax.device_put(jnp.asarray(cur), sharding)
        res = fn(dev_prev, dev_cur)
        good = np.asarray(res.good)
        for i in range(b):
            if alive[i]:
                danger_counts[i].append(int(good[i].sum()))
        prev = cur
        dev_prev = dev_cur
        n_steps += 1
        since_save += 1
        if cfg.checkpoint_path and since_save >= cfg.checkpoint_every:
            save_checkpoint(
                cfg.checkpoint_path,
                n_steps=np.int64(n_steps),
                prev=prev.astype(np.uint8),
                alive=alive.copy(),
            )
            since_save = 0

    wall = time.time() - t0
    total_frames = sum(len(d) for d in danger_counts)
    return {
        "streams": b,
        "devices": n_dev,
        "steps": n_steps - n_steps0,
        "first_step": start,
        "total_frames": total_frames,
        "wall_s": wall,
        "aggregate_fps": total_frames / max(wall, 1e-9),
        "mean_danger_per_stream": [
            float(np.mean(d)) if d else 0.0 for d in danger_counts
        ],
        "danger_counts": danger_counts,
    }


def run_batch_staged(cfg: BatchRunnerConfig, reps: int = 3) -> dict:
    """Compute-path companion of run_batch: all frames staged on device
    once, then device-resident chunked scans (flow/lk_grid.py
    lk_grid_flow_video at ONE compiled chunk shape, chunks overlapping
    by one frame) — the multi-stream aggregate without per-step
    host-to-device transfers. Streams run one after another on one
    device. Steady-state time over `reps` passes; per-stream danger
    sequences come out identical to the streaming path
    (tests/test_apps.py)."""
    from ..flow.lk_grid import lk_grid_flow_video

    chunk = 24
    frames = []
    for v in cfg.videos:
        pre = FramePrefetcher(v, max_frames=cfg.max_frames, to_device=False)
        frames.append(np.stack(list(pre)))
    h, w = frames[0].shape[1:]
    pts = jnp.asarray(measurement_grid(h, w, cfg.step))

    @jax.jit
    def scan_chunk(fr):
        res = lk_grid_flow_video(
            fr.astype(jnp.float32), pts,
            lk=cfg.lk, norm=cfg.norm, filt=cfg.filt,
        )
        return jnp.sum(res.good, axis=1)  # (chunk,) per-pair counts

    # stage every stream on device once (u8)
    dev_streams = [jax.device_put(jnp.asarray(f)) for f in frames]
    # pad tail chunks by repeating the last frame (results masked off)
    def run_once():
        counts = []
        for f in dev_streams:
            t = f.shape[0]
            out = []
            start = 0
            while start + 1 < t:
                stop = min(start + chunk + 1, t)
                piece = f[start:stop]
                valid = piece.shape[0] - 1
                if valid < chunk:
                    piece = jnp.concatenate(
                        [piece] + [piece[-1:]] * (chunk - valid)
                    )
                out.append(np.asarray(scan_chunk(piece))[:valid])
                start = stop - 1
            # a <2-frame stream yields no chunks; report it as an empty
            # count sequence (streaming path masks such streams the same)
            counts.append(
                np.concatenate(out) if out else np.zeros(0, np.int32)
            )
        return counts

    t0 = time.time()
    counts = run_once()
    compile_s = time.time() - t0
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        counts = run_once()
        best = min(best, time.time() - t0)
    total_frames = sum(len(c) for c in counts)
    return {
        "streams": len(frames),
        "total_frames": total_frames,
        "wall_s": best,
        "compile_s": compile_s,
        "aggregate_fps": total_frames / max(best, 1e-9),
        "mean_danger_per_stream": [
            float(c.mean()) if len(c) else 0.0 for c in counts
        ],
        "danger_counts": [c.astype(int).tolist() for c in counts],
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="multi-stream batched pathfinder")
    p.add_argument("videos", nargs="+", help="videos or .npy/.npz frame stacks")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument(
        "--staged",
        action="store_true",
        help="compute-path mode: stage all frames on device once, scan "
        "on-device (no per-step H2D) — the config-4 companion number",
    )
    p.add_argument("--checkpoint", default=None)
    args = p.parse_args(argv)
    enable_compile_cache()
    cfg = BatchRunnerConfig(
        videos=args.videos,
        max_frames=args.max_frames,
        checkpoint_path=args.checkpoint,
        lk=LKParams(compute_err=False),
    )
    stats = run_batch_staged(cfg) if args.staged else run_batch(cfg)
    stats.pop("danger_counts", None)
    print(stats)


if __name__ == "__main__":
    main()
