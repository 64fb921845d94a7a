"""Long-sequence checkpoint/resume soak.

The reference's long benchmark clips are >=2875 frames
(.MISSING_LARGE_BLOBS, DenseOF.py:15 bookmark); this soak rebuilds that
scale by looping a 300-frame seeded 1080p clip
(hackathonopticalflow_tpu/io/synthetic.py) into ONE ~3300-frame .npy
frame stack, then:

1. reference pass — pathfinder run_batched over the whole clip,
   uninterrupted, recording every frame's danger count;
2. soak pass — the same run with --checkpoint, except the parent
   SIGKILLs the worker process at random intervals and relaunches it
   until it finishes; every segment logs (first_pair_frame,
   danger_counts) to a jsonl;
3. the segments are overlaid by ABSOLUTE frame index (a resume re-emits
   the frames between its checkpoint and the kill point; overlaps must
   agree) and the reconstructed stream is asserted IDENTICAL to the
   uninterrupted pass.

Workers run one at a time (the parent itself never imports jax), so the
GPU holds one JAX process at any moment. Usage:
python benchmarks/soak_resume.py [--frames 3300] [--kill-every 30]
[--cpu] [--workdir DIR]  (DIR defaults to soak_resume/ under the system
temporary directory; the 1080p clip there takes ~7 GB).

Reference: pathfinder_viewer.py:15,240 (the state-losing seek this
replaces), SURVEY.md §5.4.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP = 300  # frames of seeded clip repeated to the requested length


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_clip(path: str, n_frames: int) -> int:
    """Loop a seeded 1080p clip into one long .npy frame stack (cached)."""
    import numpy as np

    if os.path.exists(path):
        have = np.load(path, mmap_mode="r").shape[0]
        if have >= n_frames:
            log(f"soak clip cached: {have} frames")
            return have
    sys.path.insert(0, REPO)
    from hackathonopticalflow_tpu.io.synthetic import seeded_clip

    t0 = time.time()
    loop = seeded_clip(min(LOOP, n_frames), 1080, 1920, seed=0)
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.uint8, shape=(n_frames, 1080, 1920)
    )
    for start in range(0, n_frames, len(loop)):
        stop = min(start + len(loop), n_frames)
        out[start:stop] = loop[: stop - start]
    out.flush()
    del out
    log(f"built soak clip: {n_frames} frames in {time.time() - t0:.0f}s")
    return n_frames


def segment(args) -> None:
    """Worker mode: one pathfinder segment (resumes via checkpoint)."""
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from hackathonopticalflow_tpu.apps.pathfinder import (
        PathfinderApp,
        PathfinderConfig,
    )
    from hackathonopticalflow_tpu.core.config import LKParams

    cfg = PathfinderConfig(
        video=os.path.join(args.workdir, "soak_long.npy"),
        max_frames=args.frames - 1,
        checkpoint_path=args.checkpoint if args.checkpoint else None,
        checkpoint_every=96,
        lk=LKParams(compute_err=False),
    )
    def on_chunk(first, danger):
        # STREAM chunk outputs: a SIGKILLed segment has already
        # exported everything it consumed
        with open(args.out, "a") as f:
            f.write(json.dumps({"first": int(first), "danger": danger}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    stats = PathfinderApp(cfg).run_batched(
        chunk=24, render=False, on_chunk=on_chunk
    )
    log(
        f"segment done: first={stats['first_pair_frame']} "
        f"frames={stats['frames']} fps={stats['fps']:.2f}"
    )


def overlay(jsonl: str, n_pairs: int):
    """Reconstruct the stream by absolute index; verify overlaps agree."""
    stream = [None] * (n_pairs + 2)
    with open(jsonl) as f:
        for line in f:
            seg = json.loads(line)
            for i, v in enumerate(seg["danger"]):
                idx = seg["first"] + i
                if stream[idx] is not None and stream[idx] != v:
                    raise AssertionError(
                        f"overlap mismatch at frame {idx}: "
                        f"{stream[idx]} vs {v}"
                    )
                stream[idx] = v
    return stream


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3300)
    ap.add_argument("--kill-every", type=float, default=30.0,
                    help="seconds between SIGKILLs of the soak worker")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--segment", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "soak_resume"))
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-ref", action="store_true",
                    help="reuse an existing soak_ref.jsonl in --workdir")
    args = ap.parse_args()
    if args.segment:
        segment(args)
        return 0

    os.makedirs(args.workdir, exist_ok=True)
    have = build_clip(os.path.join(args.workdir, "soak_long.npy"), args.frames)
    args.frames = min(args.frames, have)
    n_pairs = args.frames - 1

    base_cmd = [sys.executable, os.path.abspath(__file__), "--segment",
                "--frames", str(args.frames), "--workdir", args.workdir]
    if args.cpu:
        base_cmd.append("--cpu")

    # 1. uninterrupted reference pass
    ref_out = os.path.join(args.workdir, "soak_ref.jsonl")
    seg_out = os.path.join(args.workdir, "soak_segments.jsonl")
    ckpt = os.path.join(args.workdir, "soak.ckpt.npz")
    skip = args.skip_ref and os.path.exists(ref_out)
    # with --skip-ref, accumulated soak segments + the checkpoint are
    # kept as well (the harness itself may be restarted; overlay()
    # handles overlaps) — a fresh run wipes everything
    for p in (
        [] if skip
        else [ref_out, seg_out, ckpt]
    ):
        if os.path.exists(p):
            os.unlink(p)
    t0 = time.time()
    if not skip:
        log("=== reference pass (uninterrupted) ===")
        subprocess.run(base_cmd + ["--out", ref_out], check=True, cwd=REPO)
    ref_wall = time.time() - t0
    ref = overlay(ref_out, n_pairs)
    assert all(v is not None for v in ref[1 : n_pairs + 1]), "ref gaps"

    # 2. soak pass: SIGKILL the worker until it survives to the end
    log(f"=== soak pass (SIGKILL every ~{args.kill_every}s) ===")
    kills = 0
    t0 = time.time()
    while True:
        proc = subprocess.Popen(
            base_cmd
            + ["--out", seg_out, "--checkpoint", ckpt],
            cwd=REPO,
        )
        try:
            rc = proc.wait(timeout=args.kill_every)
            if rc == 0:
                break
            log(f"worker exited rc={rc}; relaunching")
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            kills += 1
            log(f"SIGKILL #{kills}")
    soak_wall = time.time() - t0

    # 3. reconstruct and compare
    got = overlay(seg_out, n_pairs)
    missing = [i for i in range(1, n_pairs + 1) if got[i] is None]
    assert not missing, f"gaps at {missing[:10]}"
    diff = [i for i in range(1, n_pairs + 1) if got[i] != ref[i]]
    assert not diff, f"mismatches at {diff[:10]}"
    print(
        json.dumps(
            {
                "soak": "PASSED",
                "frames": n_pairs,
                "kills": kills,
                "ref_wall_s": round(ref_wall, 1),
                "soak_wall_s": round(soak_wall, 1),
                "ref_fps": round(n_pairs / ref_wall, 2),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
