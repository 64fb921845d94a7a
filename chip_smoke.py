#!/usr/bin/env python3
"""Smoke test of the flow engine on NVIDIA GPUs.

    python3 chip_smoke.py           # one GPU: sparse, dense, tracker, parity
    python3 chip_smoke.py --multi   # four GPUs: stream DP + tiled dense only

Runs the three deployments through their user entry points on seeded
frames (hackathonopticalflow_tpu/io/synthetic.py; no corpus is read):

1. sparse pathfinder — 1080p, grid step 30 (2304 points), LK window 45,
   through the `--chunk 24 --no-render` command-line path;
2. dense Farneback — 720p, reference parameters, farneback_flow_video;
3. trajectory tracker — 1080p, TrackerParams() (window 15, capacity 256),
   track_video;
4. parity — the Triton LK kernel against the XLA level loop on the GPU,
   and each path above against the same XLA code on the host CPU, in
   this process.

The times printed are smoke timings (one short run, compile separate),
not benchmark numbers. Any failed phase exits non-zero before the last
line, which is one JSON object naming the device. Without a GPU the
script exits non-zero at once and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# parity bounds (PERF.md section 2 says why each is what it is)
LK_STATUS_AGREE = 0.999  # share of points whose status bits agree
LK_ENDPOINT_TOL = 1e-2  # px, on LK_ENDPOINT_SHARE of points both track
LK_ENDPOINT_SHARE = 0.99
DANGER_AGREE = 0.995  # share of points per frame with the same danger bit
FARNEBACK_MEAN_EPE = 1e-3  # px, mean over the frame
TRACK_ALIVE_AGREE = 0.99
TRACK_HEAD_TOL = 1e-2  # px, on LK_ENDPOINT_SHARE of tracks both keep


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed(fn, *args, reps=3):
    """(first-call seconds, median steady seconds, result)."""
    import jax

    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    steady = []
    for _ in range(reps):
        t = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        steady.append(time.perf_counter() - t)
    return first, float(np.median(steady)), out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare_lk(ref_pts, ref_st, pts, st, label):
    """Status agreement and endpoint deltas against the reference."""
    agree = float(np.mean(ref_st == st))
    both = ref_st & st
    d = np.linalg.norm(ref_pts - pts, axis=-1)[both]
    share = float(np.mean(d <= LK_ENDPOINT_TOL)) if d.size else 1.0
    say(
        f"  parity {label}: status agree {agree:.5f} (>= {LK_STATUS_AGREE}); "
        f"|d| <= {LK_ENDPOINT_TOL} px on {share:.5f} of {d.size} tracked "
        f"(>= {LK_ENDPOINT_SHARE}); max |d| {d.max(initial=0.0):.3e} px; "
        f"float32"
    )
    check(agree >= LK_STATUS_AGREE, f"{label}: status agreement {agree}")
    check(share >= LK_ENDPOINT_SHARE, f"{label}: endpoint share {share}")


def chain_levels(prev, nxt, pts, params, use_kernel):
    """pyr_lk's coarse-to-fine loop with the level step forced to one
    implementation (the dispatch in ops/lk.py picks by platform)."""
    import jax.numpy as jnp

    from hackathonopticalflow_tpu.ops.lk import _frame_pad, _level_lk_xla
    from hackathonopticalflow_tpu.ops.lk_triton import level_lk_triton

    win_w, win_h = params.win_size
    half = jnp.array([(win_w - 1) * 0.5, (win_h - 1) * 0.5], jnp.float32)
    center = pts * (1.0 / (1 << params.max_level))
    status = jnp.ones(pts.shape[0], bool)
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            center = center * 2.0
        args = (
            prev.img_p[level], prev.dix_p[level], prev.diy_p[level],
            nxt.img_p[level], pts, center - half, status,
        )
        if use_kernel:
            tl, status, _ = level_lk_triton(
                *args, level=level, win_size=params.win_size,
                pad=_frame_pad(params), max_iters=params.max_iters,
                eps=params.eps, min_eig_threshold=params.min_eig_threshold,
                compute_err=params.compute_err,
            )
        else:
            tl, status, _ = _level_lk_xla(*args, level=level, params=params)
        center = tl + half
    return center, status


def phase_kernel(frames):
    """Triton LK kernel vs the XLA level loop, both on the GPU."""
    import jax
    import jax.numpy as jnp

    from hackathonopticalflow_tpu.core.config import LKParams, TRACKER_LK
    from hackathonopticalflow_tpu.core.grid import measurement_grid
    from hackathonopticalflow_tpu.ops.lk import prepare_frame

    h, w = frames.shape[1:]
    rng = np.random.RandomState(0)
    tracker_pts = np.stack(
        [rng.uniform(20, w - 20, 256), rng.uniform(20, h - 20, 256)], -1
    ).astype(np.float32)
    cases = (
        ("sparse grid30 win45", LKParams(compute_err=False), measurement_grid(h, w, 30)),
        ("tracker 256 win15", TRACKER_LK, tracker_pts),
    )
    for label, params, pts in cases:
        prep = jax.jit(functools.partial(prepare_frame, params=params))
        prev = prep(jnp.asarray(frames[1]))
        nxt = prep(jnp.asarray(frames[0]))
        pts = jnp.asarray(pts)
        out = {}
        for use_kernel in (False, True):
            fn = jax.jit(functools.partial(chain_levels, params=params, use_kernel=use_kernel))
            first, steady, res = timed(fn, prev, nxt, pts, reps=10)
            out[use_kernel] = jax.device_get(res)
            say(
                f"[smoke] LK levels {label}: {'triton kernel' if use_kernel else 'xla loop'} "
                f"{h}x{w} N={pts.shape[0]} | compile {first - steady:.2f} s | "
                f"steady {steady * 1e3:.3f} ms per pair (smoke timing)"
            )
        compare_lk(out[False][0], out[False][1], out[True][0], out[True][1],
                   f"{label} triton vs xla (gpu)")


def phase_sparse(frames, workdir, cpu):
    import jax
    import jax.numpy as jnp

    from hackathonopticalflow_tpu.apps.pathfinder import parse_cli, run_cli
    from hackathonopticalflow_tpu.core.grid import measurement_grid
    from hackathonopticalflow_tpu.flow.lk_grid import lk_grid_flow_video

    t, h, w = frames.shape
    clip = os.path.join(workdir, "sparse_1080p.npy")
    np.save(clip, frames)
    cfg, args = parse_cli([clip, "--chunk", "24", "--no-render"])
    t0 = time.perf_counter()
    stats = run_cli(cfg, args)
    total = time.perf_counter() - t0
    counts = np.asarray(stats["danger_counts"])
    say(
        f"[smoke] sparse pathfinder: {t}x{h}x{w} grid {cfg.step} "
        f"({measurement_grid(h, w, cfg.step).shape[0]} pts) chunk 24 | "
        f"compile+setup {total - stats['wall_s']:.2f} s | steady "
        f"{stats['wall_s'] / max(stats['frames'], 1) * 1e3:.3f} ms/frame over "
        f"{stats['frames']} frames (smoke timing) | mean danger points "
        f"{stats['mean_danger_points']:.1f}"
    )
    check(stats["frames"] == t - 1, f"sparse: {stats['frames']} frames")
    check(0 < counts.min() and counts.max() < 2304, f"sparse: danger counts {counts}")

    # parity of the path: the same scan on the GPU and on the host CPU
    pts = measurement_grid(h, w, cfg.step)
    fn = jax.jit(functools.partial(lk_grid_flow_video, lk=cfg.lk, norm=cfg.norm, filt=cfg.filt))
    window = frames[:3]
    gpu = jax.device_get(fn(jnp.asarray(window), jnp.asarray(pts)))
    host = jax.device_get(fn(jax.device_put(window, cpu), jax.device_put(pts, cpu)))
    for i in range(window.shape[0] - 1):
        compare_lk(host.raw_next_pts[i], host.status[i], gpu.raw_next_pts[i],
                   gpu.status[i], f"sparse pair {i} gpu vs cpu")
        agree = float(np.mean(host.good[i] == gpu.good[i]))
        say(f"  parity sparse pair {i} danger mask agree {agree:.5f} (>= {DANGER_AGREE})")
        check(agree >= DANGER_AGREE, f"sparse danger agreement {agree}")
        diff = abs(int(gpu.good[i].sum()) - int(counts[i]))
        check(diff <= (1 - DANGER_AGREE) * pts.shape[0],
              f"app danger count {counts[i]} vs scan {int(gpu.good[i].sum())}")


def phase_dense(cpu):
    import jax
    import jax.numpy as jnp

    from hackathonopticalflow_tpu.core.config import FarnebackParams
    from hackathonopticalflow_tpu.flow.dense import farneback_flow_video
    from hackathonopticalflow_tpu.io.synthetic import seeded_clip
    from hackathonopticalflow_tpu.ops.farneback import farneback

    params = FarnebackParams()
    frames = seeded_clip(9, 720, 1280, seed=1)
    dev = jnp.asarray(frames)
    fn = jax.jit(lambda f: farneback_flow_video(f.astype(jnp.float32), params))
    first, steady, flows = timed(fn, dev)
    flows = np.asarray(flows)
    say(
        f"[smoke] dense farneback: 9x720x1280 levels {params.levels} win "
        f"{params.win_size} | compile {first - steady:.2f} s | steady "
        f"{steady / 8 * 1e3:.3f} ms/frame (smoke timing)"
    )
    check(flows.shape == (8, 720, 1280, 2), f"dense shape {flows.shape}")
    check(bool(np.isfinite(flows).all()), "dense: non-finite flow")

    pair = jax.jit(lambda a, b: farneback(a.astype(jnp.float32), b.astype(jnp.float32), params))
    gpu = np.asarray(pair(dev[0], dev[1]))
    host = np.asarray(pair(jax.device_put(frames[0], cpu), jax.device_put(frames[1], cpu)))
    epe = float(np.linalg.norm(gpu - host, axis=-1).mean())
    scan_epe = float(np.linalg.norm(flows[0] - gpu, axis=-1).mean())
    say(
        f"  parity dense gpu vs cpu: mean EPE {epe:.3e} px (<= {FARNEBACK_MEAN_EPE}); "
        f"scan vs pairwise {scan_epe:.3e} px; float32, convolutions f32 "
        f"multiply-adds"
    )
    check(epe <= FARNEBACK_MEAN_EPE, f"dense EPE {epe}")
    check(scan_epe <= FARNEBACK_MEAN_EPE, f"dense scan EPE {scan_epe}")


def phase_tracker(frames, cpu):
    import jax
    import jax.numpy as jnp

    from hackathonopticalflow_tpu.core.config import TrackerParams
    from hackathonopticalflow_tpu.flow.tracker import track_video

    params = TrackerParams()
    fn = jax.jit(lambda f: track_video(f, params))
    clip = frames[:20]
    first, steady, (state, hist) = timed(fn, jnp.asarray(clip))
    heads, alive, _ = map(np.asarray, hist)
    say(
        f"[smoke] tracker: {clip.shape[0]}x{clip.shape[1]}x{clip.shape[2]} "
        f"capacity {params.max_tracks} win {params.lk.win_size[0]} | compile "
        f"{first - steady:.2f} s | steady {steady / (clip.shape[0] - 1) * 1e3:.3f} "
        f"ms/frame (smoke timing) | live tracks at end {int(alive[-1].sum())}"
    )
    check(alive[-1].sum() > 0, "tracker: no live tracks")
    check(bool(np.isfinite(heads[alive]).all()), "tracker: non-finite heads")

    short = clip[:8]
    gpu = jax.device_get(fn(jnp.asarray(short))[1])
    host = jax.device_get(fn(jax.device_put(short, cpu))[1])
    agree = float(np.mean(gpu[1] == host[1]))
    both = gpu[1] & host[1]
    d = np.linalg.norm(gpu[0] - host[0], axis=-1)[both]
    share = float(np.mean(d <= TRACK_HEAD_TOL)) if d.size else 1.0
    say(
        f"  parity tracker gpu vs cpu (8 frames): alive agree {agree:.5f} "
        f"(>= {TRACK_ALIVE_AGREE}); heads |d| <= {TRACK_HEAD_TOL} px on "
        f"{share:.5f} of {d.size} (>= {LK_ENDPOINT_SHARE}); float32"
    )
    check(agree >= TRACK_ALIVE_AGREE, f"tracker alive agreement {agree}")
    check(share >= LK_ENDPOINT_SHARE, f"tracker head share {share}")


def phase_multi(workdir):
    """Stream DP over four GPUs and tiled dense flow over a (1, 4) mesh,
    each against the single-device result."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from __graft_entry__ import dryrun_multichip
    from hackathonopticalflow_tpu.apps.batch_runner import BatchRunnerConfig, run_batch
    from hackathonopticalflow_tpu.core.config import FarnebackParams, LKParams
    from hackathonopticalflow_tpu.io.synthetic import seeded_clip
    from hackathonopticalflow_tpu.ops.farneback import farneback
    from hackathonopticalflow_tpu.parallel.mesh import make_mesh
    from hackathonopticalflow_tpu.parallel.tiling import TileConfig, tiled_farneback_multi

    n = len(jax.devices())
    check(n >= 4, f"--multi needs 4 GPUs, found {n}")
    paths = []
    for s in range(4):
        p = os.path.join(workdir, f"stream{s}.npy")
        np.save(p, seeded_clip(13, 1080, 1920, seed=10 + s))
        paths.append(p)
    lk = LKParams(compute_err=False)
    t0 = time.perf_counter()
    multi = run_batch(BatchRunnerConfig(videos=paths, lk=lk, n_devices=4))
    t_multi = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = run_batch(BatchRunnerConfig(videos=paths, lk=lk, n_devices=1))
    t_single = time.perf_counter() - t0
    say(
        f"[smoke] stream DP: 4 streams x 13x1080x1920 on {multi['devices']} GPUs | "
        f"total {t_multi:.2f} s, steady {multi['aggregate_fps']:.2f} frames/s | "
        f"one GPU: total {t_single:.2f} s, steady {single['aggregate_fps']:.2f} "
        f"frames/s (smoke timings)"
    )
    same = multi["danger_counts"] == single["danger_counts"]
    say(f"  parity stream DP vs one device: danger counts identical {same}")
    check(same, "stream DP danger counts differ from one device")

    params = FarnebackParams()
    # the widest halo a 270-row tile holds (two coarsest-level strides of
    # 8 rows go to grid alignment, parallel/tiling.py); rows within the
    # halo of the frame's top and bottom edges differ by design
    tile = TileConfig(halo=1080 // 4 - 2 * 8)
    frames = seeded_clip(2, 1080, 1920, seed=20)
    mesh = make_mesh((1, 4), ("stream", "tile"))
    sh = NamedSharding(mesh, P("stream", "tile", None))
    prev = jax.device_put(frames[None, 0].astype(np.float32), sh)
    cur = jax.device_put(frames[None, 1].astype(np.float32), sh)
    tiled_fn = jax.jit(lambda a, b: tiled_farneback_multi(a, b, mesh, params, tile))
    first, steady, tiled = timed(tiled_fn, prev, cur)
    one = jax.jit(lambda a, b: farneback(a, b, params))
    ref = np.asarray(one(jnp.asarray(frames[0], jnp.float32), jnp.asarray(frames[1], jnp.float32)))
    epe_all = np.linalg.norm(np.asarray(tiled)[0] - ref, axis=-1)
    epe = epe_all[tile.halo : -tile.halo]
    say(
        f"[smoke] tiled dense: 1080x1920 over a (1, 4) mesh, halo {tile.halo} | "
        f"compile {first - steady:.2f} s | steady {steady * 1e3:.3f} ms/pair "
        f"(smoke timing)"
    )
    say(
        f"  parity tiled vs one device, rows {tile.halo}..{1080 - tile.halo}: "
        f"mean EPE {epe.mean():.3e} px (<= {FARNEBACK_MEAN_EPE}); max "
        f"{epe.max():.3e} px; whole frame mean {epe_all.mean():.3e} px"
    )
    check(epe.mean() <= FARNEBACK_MEAN_EPE, f"tiled EPE {epe.mean()}")

    t0 = time.perf_counter()
    dryrun_multichip(4)
    say(f"[smoke] dryrun_multichip(4): ok in {time.perf_counter() - t0:.2f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: stream DP and tiled dense flow only")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    try:
        from hackathonopticalflow_tpu.io.synthetic import seeded_clip
        from hackathonopticalflow_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    say(card_line())
    say(f"jax {jax.__version__} devices {jax.devices()}")
    cpu = jax.devices("cpu")[0]
    try:
        with tempfile.TemporaryDirectory() as workdir:
            if args.multi:
                phase_multi(workdir)
            else:
                frames = seeded_clip(49, 1080, 1920, seed=0)
                phase_sparse(frames, workdir, cpu)
                phase_dense(cpu)
                phase_tracker(frames, cpu)
                phase_kernel(frames)
    except Exception:
        traceback.print_exc()
        return 1
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
