"""Kernel and form choices on one NVIDIA GPU, end to end.

    python benchmarks/gpu_forms.py [--out results.json]

Times, in one process and in alternating order (A B B A per pair of
forms), the choices the GPU translation made:

1. LK level loop: the Triton kernel (ops/lk_triton.py) against the XLA
   loop (ops/lk.py _level_lk_xla), end to end in the sparse pathfinder
   (1080p, grid 30, window 45, the `--chunk 24 --no-render` path) and in
   the tracker (1080p, TrackerParams(), track_video over 20 frames);
2. separable convolution: shifted multiply-adds (ops/image.py) against a
   one-channel conv_general_dilated at Precision.HIGHEST, per tap set and
   end to end in dense Farneback (720p);
3. Farneback box blur: doubling partial sums (ops/image.box_sum) against
   an integral image (two cumsums), end to end in dense Farneback.

Each alternative is swapped in by replacing one module function, so the
rest of the path is the same code. Prints one JSON line (all numbers,
with the card's name and power limit) and writes it to --out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import importlib  # noqa: E402

# modules by name: the ops package re-exports a function called farneback
fb_mod = importlib.import_module("hackathonopticalflow_tpu.ops.farneback")
image_mod = importlib.import_module("hackathonopticalflow_tpu.ops.image")
lk_mod = importlib.import_module("hackathonopticalflow_tpu.ops.lk")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def swapped(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _xla_level(*args, level, win_size, pad, max_iters, eps,
               min_eig_threshold, compute_err, interpret=False):
    """level_lk_triton's signature over the XLA loop."""
    from hackathonopticalflow_tpu.core.config import LKParams

    params = LKParams(win_size=win_size, max_iters=max_iters, eps=eps,
                      min_eig_threshold=min_eig_threshold,
                      compute_err=compute_err)
    return lk_mod._level_lk_xla(*args, level=level, params=params)


def _conv_correlate1d(x, k, axis):
    """One-channel conv_general_dilated form of image._correlate1d."""
    shape = x.shape
    h, w = shape[-2:]
    x4 = x.reshape((-1, 1, h, w))
    kern = k[:, None] if axis == x.ndim - 2 else k[None, :]
    y = lax.conv_general_dilated(
        x4, kern[None, None].astype(x.dtype), (1, 1), "VALID",
        precision=lax.Precision.HIGHEST,
    )
    return y.reshape(shape[:-2] + y.shape[-2:])


def _cumsum_blur(m, win_size):
    """Integral-image form of farneback.update_flow_blur (odd windows)."""
    r = win_size // 2
    p = jnp.pad(m, ((0, 0), (r + 1, r), (r + 1, r)), mode="edge")
    c = jnp.cumsum(p, axis=-2)
    rows = c[:, win_size:, :] - c[:, :-win_size, :]
    c2 = jnp.cumsum(rows, axis=-1)
    ms = c2[:, :, win_size:] - c2[:, :, :-win_size]
    return fb_mod._cramer_solve(ms * (1.0 / (win_size * win_size)))


def steady(fn, *args, reps=5):
    t = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return first, float(np.median(ts)), out


def abba(label, run_a, run_b, rounds=2):
    """Alternate A B B A `rounds` times; returns medians of each side."""
    a, b = [], []
    for i in range(rounds):
        first, second = (run_a, run_b) if i % 2 == 0 else (run_b, run_a)
        for fn in (first, second, second, first):
            (a if fn is run_a else b).append(fn())
    res = {"a": a, "b": b, "a_median": float(np.median(a)),
           "b_median": float(np.median(b))}
    log(f"{label}: A {res['a_median'] * 1e3:.3f} ms  B {res['b_median'] * 1e3:.3f} ms  "
        f"(A runs {[round(x * 1e3, 3) for x in a]}, B runs {[round(x * 1e3, 3) for x in b]})")
    return res


def lk_end_to_end(frames, workdir):
    from hackathonopticalflow_tpu.apps.pathfinder import parse_cli, run_cli
    from hackathonopticalflow_tpu.core.config import TrackerParams
    from hackathonopticalflow_tpu.flow.lk_grid import lk_grid_flow_video
    from hackathonopticalflow_tpu.core.grid import measurement_grid
    from hackathonopticalflow_tpu.flow.tracker import track_video

    clip = os.path.join(workdir, "clip.npy")
    np.save(clip, frames)
    cfg, args = parse_cli([clip, "--chunk", "24", "--no-render"])

    def app_run(xla):
        with swapped(lk_mod, "level_lk_triton", _xla_level) if xla else contextlib.nullcontext():
            stats = run_cli(cfg, args)
        return stats["wall_s"] / stats["frames"]

    out = {"sparse_app_s_per_frame": abba(
        "sparse app s/frame (A xla, B kernel)",
        lambda: app_run(True), lambda: app_run(False), rounds=1)}

    h, w = frames.shape[1:]
    pts = jnp.asarray(measurement_grid(h, w, 30))
    dev25 = jnp.asarray(frames[:25])

    def scan_fn(xla):
        with swapped(lk_mod, "level_lk_triton", _xla_level) if xla else contextlib.nullcontext():
            fn = jax.jit(lambda f: lk_grid_flow_video(f, pts, lk=cfg.lk))
            _, t, _ = steady(fn, dev25, reps=3)
        return t / 24

    out["sparse_scan_s_per_frame"] = abba(
        "sparse scan s/frame (A xla, B kernel)",
        lambda: scan_fn(True), lambda: scan_fn(False), rounds=1)

    params = TrackerParams()
    dev20 = jnp.asarray(frames[:20])

    def track_fn(xla):
        with swapped(lk_mod, "level_lk_triton", _xla_level) if xla else contextlib.nullcontext():
            fn = jax.jit(lambda f: track_video(f, params))
            _, t, _ = steady(fn, dev20, reps=3)
        return t / 19

    out["tracker_s_per_frame"] = abba(
        "tracker s/frame (A xla, B kernel)",
        lambda: track_fn(True), lambda: track_fn(False), rounds=1)
    return out


def conv_forms():
    """Per-tap-set times of the two separable-convolution forms."""
    from hackathonopticalflow_tpu.ops.farneback import _poly_exp_consts
    from hackathonopticalflow_tpu.ops.image import gaussian_kernel1d

    rng = np.random.RandomState(0)
    img1080 = jnp.asarray(rng.uniform(0, 255, (1080, 1920)).astype(np.float32))
    img720 = jnp.asarray(rng.uniform(0, 255, (720, 1280)).astype(np.float32))
    g, _, _, *_ = _poly_exp_consts(5, 1.2)
    one = jnp.ones((1,), jnp.float32)
    cases = {
        "pyrdown_5tap_1080p": (img1080, jnp.array([1, 4, 6, 4, 1.0]) / 16, jnp.array([1, 4, 6, 4, 1.0]) / 16, "reflect"),
        "scharr_3tap_1080p": (img1080, jnp.array([3, 10, 3.0]) / 32, jnp.array([-1, 0, 1.0]), "reflect"),
        "polyexp_11tap_v_720p": (img720, jnp.asarray(g), one, "edge"),
        "polyexp_11tap_h_720p": (img720, one, jnp.asarray(g), "edge"),
        "blur_17tap_720p": (img720, gaussian_kernel1d(17, 3.5), gaussian_kernel1d(17, 3.5), "reflect"),
    }
    out = {}
    for name, (img, ky, kx, mode) in cases.items():
        def run(conv, img=img, ky=ky, kx=kx, mode=mode):
            with swapped(image_mod, "_correlate1d", _conv_correlate1d) if conv else contextlib.nullcontext():
                fn = jax.jit(lambda x: image_mod.sep_conv2d(x, ky, kx, mode=mode))
                _, t, y = steady(fn, img, reps=10)
            return t, np.asarray(y)

        res = abba(f"sep_conv {name} (A shifted adds, B conv HIGHEST)",
                   lambda: run(False)[0], lambda: run(True)[0], rounds=1)
        res["max_abs_diff"] = float(np.abs(run(False)[1] - run(True)[1]).max())
        out[name] = res
    return out


def dense_forms(cpu):
    from hackathonopticalflow_tpu.core.config import FarnebackParams
    from hackathonopticalflow_tpu.flow.dense import farneback_flow_video
    from hackathonopticalflow_tpu.io.synthetic import seeded_clip
    from hackathonopticalflow_tpu.ops.farneback import farneback

    params = FarnebackParams()
    frames = seeded_clip(9, 720, 1280, seed=1)
    dev = jnp.asarray(frames)
    ref = np.asarray(jax.jit(lambda a, b: farneback(a.astype(jnp.float32), b.astype(jnp.float32), params))(
        jax.device_put(frames[0], cpu), jax.device_put(frames[1], cpu)))

    def run(conv=False, cumsum=False):
        ctx = contextlib.ExitStack()
        if conv:
            ctx.enter_context(swapped(image_mod, "_correlate1d", _conv_correlate1d))
        if cumsum:
            ctx.enter_context(swapped(fb_mod, "update_flow_blur", _cumsum_blur))
        with ctx:
            fn = jax.jit(lambda f: farneback_flow_video(f.astype(jnp.float32), params))
            _, t, flows = steady(fn, dev, reps=3)
            pair = jax.jit(lambda a, b: farneback(a.astype(jnp.float32), b.astype(jnp.float32), params))
            epe = float(np.linalg.norm(np.asarray(pair(dev[0], dev[1])) - ref, axis=-1).mean())
        return t / 8, epe

    out = {}
    for key, kw, label in (
        ("conv", dict(conv=True), "dense 720p s/frame (A shifted adds, B conv HIGHEST)"),
        ("blur", dict(cumsum=True), "dense 720p s/frame (A doubling box, B cumsum box)"),
    ):
        res = abba(label, lambda: run()[0], lambda kw=kw: run(**kw)[0], rounds=1)
        res["a_mean_epe_vs_cpu"] = run()[1]
        res["b_mean_epe_vs_cpu"] = run(**kw)[1]
        log(f"  mean EPE vs CPU exact: A {res['a_mean_epe_vs_cpu']:.3e}  B {res['b_mean_epe_vs_cpu']:.3e}")
        out[key] = res
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        log("gpu_forms: needs a GPU")
        return 1
    from hackathonopticalflow_tpu.io.synthetic import seeded_clip
    from hackathonopticalflow_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(card)
    cpu = jax.devices("cpu")[0]
    result = {"card": card, "device_kind": jax.devices()[0].device_kind}
    frames = seeded_clip(49, 1080, 1920, seed=0)
    with tempfile.TemporaryDirectory() as d:
        result["lk"] = lk_end_to_end(frames, d)
    result["sep_conv"] = conv_forms()
    result["dense"] = dense_forms(cpu)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
