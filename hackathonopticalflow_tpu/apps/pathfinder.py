"""The pathfinder viewer application — a re-design of
pathfinder_viewer.py:226-361.

Pipeline per frame (device): gray conversion -> grid LK flow -> radial
normalize -> robust filter -> danger scoring; (host): layer rendering and
compositing, FPS overlay. Supports:

- interactive mode (cv2 GUI) with the reference's keyboard map
  (pathfinder_viewer.py:314-337): space pause, 1 vectors, 2 lamps,
  3 lamps window, 4 filtered vectors, q/esc quit;
- headless mode: render composited frames to an mp4 (CI-able), or run
  compute-only for benchmarking;
- start_frame seek and frame stepping like the reference's crude
  checkpoint (pathfinder_viewer.py:15,240).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import FilterParams, GridParams, LKParams, NormalizeParams
from ..core.grid import measurement_grid
from ..flow.lk_grid import (
    GridFlowResult,
    lk_grid_flow,
    lk_grid_flow_video,
    pack_grid_result,
    unpack_grid_result,
)
from ..io.prefetch import FramePrefetcher
from ..io.video import HAVE_CV2, VideoReader, to_gray
from ..utils.compile_cache import enable_compile_cache
from ..utils.logging import get_logger
from ..viz.draw import add_layers, put_text
from ..viz.layers import draw_grid, draw_grid_vectors, draw_sparse_lamps

log = get_logger("apps.pathfinder")


@dataclasses.dataclass
class PathfinderConfig:
    video: str
    add_sparse_flow: bool = True  # pathfinder_viewer.py:11
    add_sparse_lamps: bool = True  # :12
    show_lamps: bool = False  # :13
    draw_bad_flow: bool = True  # :14
    start_frame: int = 0  # :15
    step: int = 30  # :16
    max_frames: int | None = None
    viewing_angle: float = 155.0  # :47
    viewing_angle_req: float = 60.0  # :48
    lk: LKParams = LKParams()
    norm: NormalizeParams = NormalizeParams()
    filt: FilterParams = FilterParams()
    #: true checkpoint/resume (utils/checkpoint.py) — the reference only
    #: has the state-losing start_frame seek (pathfinder_viewer.py:15,240).
    #: When set, run_batched atomically saves (absolute frame index,
    #: previous gray frame) at chunk boundaries and, on start, resumes
    #: from the file if it exists; the resumed output stream is
    #: numerically identical to the uninterrupted one
    #: (tests/test_apps.py::test_pathfinder_checkpoint_resume).
    checkpoint_path: str | None = None
    #: save cadence in frames (rounded up to chunk boundaries).
    checkpoint_every: int = 96


class PathfinderApp:
    def __init__(self, cfg: PathfinderConfig):
        self.cfg = cfg
        self.reader = VideoReader(cfg.video)
        h, w = self.reader.height, self.reader.width
        self.pts = measurement_grid(h, w, cfg.step)
        # frames cross the host->device link as uint8 (4x smaller than
        # f32); lk_grid_flow casts to f32 on device
        self._flow_fn = jax.jit(
            functools.partial(
                lk_grid_flow, lk=cfg.lk, norm=cfg.norm, filt=cfg.filt
            )
        )
        log.info("Video file %s (%dx%d, %d frames)", cfg.video, w, h, self.reader.length)

    def compute_frame(self, prev_gray: np.ndarray, gray: np.ndarray):
        """Device-side computation for one frame pair."""
        return self._flow_fn(jnp.asarray(prev_gray), jnp.asarray(gray), self.pts)

    def render_frame(self, img: np.ndarray, res, fps: float | None = None) -> np.ndarray:
        """Host-side layer compositing (pathfinder_viewer.py:292-312)."""
        cfg = self.cfg
        h, w = img.shape[:2]
        if img.ndim == 2:  # gray frame stacks render on a gray background
            img = np.repeat(img[..., None], 3, axis=-1)
        layers = [img]
        good = np.asarray(res.good)
        pts_i = np.asarray(res.pts)
        next_i = np.asarray(res.next_pts)
        if cfg.add_sparse_flow:
            layers.append(
                draw_grid_vectors((h, w), pts_i, next_i, good, cfg.draw_bad_flow)
            )
        if cfg.add_sparse_lamps:
            flow_good = (next_i - pts_i)[good]
            layers.append(draw_sparse_lamps((h, w), flow_good, pts_i[good]))
        out = add_layers(*layers)
        out = add_layers(
            out,
            draw_grid(
                (h, w),
                20,
                colored_cross=True,
                viewing_angle_rect=True,
                cross=True,
                grid=False,
                blinds=True,
                viewing_angle=cfg.viewing_angle,
                viewing_angle_req=cfg.viewing_angle_req,
            ),
        )
        if fps is not None:
            put_text(out, f"{fps:.2f} FPS", (20, 30))
        return out

    def run(
        self,
        headless: bool = True,
        out_path: str | None = None,
        render: bool = True,
    ) -> dict:
        """Process the video; returns run metrics. headless=False opens the
        interactive cv2 window with the reference's keyboard map."""
        cfg = self.cfg
        reader = self.reader
        if cfg.start_frame:
            reader.seek(cfg.start_frame)
        prev = reader.read()
        if prev is None:
            raise IOError("no first frame")
        prev_gray = to_gray(prev)
        writer = None
        if out_path is not None or not headless:
            import cv2 as _cv2
        if out_path is not None:
            fourcc = _cv2.VideoWriter_fourcc(*"mp4v")
            writer = _cv2.VideoWriter(
                out_path, fourcc, reader.fps or 25.0, (reader.width, reader.height)
            )

        n = 0
        danger_counts = []
        t_start = time.time()
        compute_s = 0.0
        # one-frame software pipeline: frame t's flow is DISPATCHED (jax
        # async dispatch, no block_until_ready) and frame t-1's already-computed result is rendered while the
        # device works; the np.asarray fetch when consuming is the only
        # sync point. Keyboard toggles therefore act one frame late —
        # imperceptible at viewer rates.
        pending: tuple | None = None  # (frame_bgr, res, t_dispatch)
        stop = False

        def consume(frame, res, t_disp):
            nonlocal compute_s, stop
            good = np.asarray(res.good)  # sync point for this frame
            # dispatch -> result-ready latency; host work overlaps it, so
            # the sum can exceed wall time
            compute_s += time.time() - t_disp
            danger_counts.append(int(good.sum()))
            if render or writer is not None or not headless:
                fps = len(danger_counts) / max(time.time() - t_start, 1e-9)
                out = self.render_frame(frame, res, fps=fps)
                if writer is not None:
                    writer.write(out)
                if not headless and HAVE_CV2:
                    if cfg.show_lamps:
                        pts_i = np.asarray(res.pts)
                        flow_good = (np.asarray(res.next_pts) - pts_i)[good]
                        _cv2.imshow(
                            "lamps",
                            draw_sparse_lamps(
                                (reader.height, reader.width), flow_good, pts_i[good]
                            ),
                        )
                    _cv2.imshow("flow", out)
                    key = _cv2.waitKey(1) & 0xFF
                    if not self._handle_key(key):
                        stop = True

        while cfg.max_frames is None or n < cfg.max_frames:
            frame = reader.read()
            if frame is None:
                break
            gray = to_gray(frame)
            t0 = time.time()
            res = self.compute_frame(prev_gray, gray)  # async dispatch
            prev_gray = gray
            n += 1
            if pending is not None:
                consume(*pending)
            pending = (frame, res, t0)
            if stop:
                pending = None
                break
        if pending is not None:
            consume(*pending)
        if writer is not None:
            writer.release()
        wall = time.time() - t_start
        frames_done = len(danger_counts)
        return {
            "frames": frames_done,
            "wall_s": wall,
            "compute_s": compute_s,
            "fps": frames_done / max(wall, 1e-9),
            "compute_fps": frames_done / max(compute_s, 1e-9),
            "mean_danger_points": float(np.mean(danger_counts)) if danger_counts else 0.0,
        }

    def run_batched(
        self,
        chunk: int = 24,
        out_path: str | None = None,
        render: bool = False,
        on_chunk=None,
    ) -> dict:
        """Headless chunked pipeline — the config-3 end-to-end path.

        A background thread decodes + gray-converts frames
        (io/prefetch.py); chunks of `chunk` frame-pairs cross to the
        device as ONE uint8 transfer; one jitted lax.scan
        (flow/lk_grid.py lk_grid_flow_video) computes the whole chunk's
        LK -> radial normalize -> robust filter; and the result fetch of
        chunk i overlaps chunk i+1's decode + dispatch (async dispatch is
        the sync point, not block_until_ready). Produces the same
        per-frame outputs as the reference's serial loop
        (pathfinder_viewer.py:270-358) with one dispatch and one fetch
        per `chunk` pairs instead of per frame. OpenCV is needed only to
        write `out_path`."""
        cfg = self.cfg
        import os

        from ..utils.checkpoint import load_checkpoint, save_checkpoint

        keep_bgr = render or out_path is not None
        h, w = self.reader.height, self.reader.width
        # resume: restore (absolute next-frame index, previous gray) —
        # the stream continues numerically identical to an uninterrupted
        # run because checkpoints land only on chunk boundaries
        resume_prev = None
        start_abs = cfg.start_frame
        if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
            saved = load_checkpoint(
                cfg.checkpoint_path,
                {
                    "frame_idx": np.int64(0),
                    "prev_gray": np.zeros((h, w), np.uint8),
                },
            )
            start_abs = int(saved["frame_idx"])
            resume_prev = np.asarray(saved["prev_gray"])
            log.info("resuming from checkpoint at frame %d", start_abs)
        # max_frames counts decoded frames from cfg.start_frame in the
        # UNINTERRUPTED run; a resumed run decodes the remainder
        end_abs = (
            None
            if cfg.max_frames is None
            else cfg.start_frame + cfg.max_frames + 1
        )
        n_decode = None if end_abs is None else max(end_abs - start_abs, 0)
        pre = FramePrefetcher(
            cfg.video,
            start_frame=start_abs,
            max_frames=n_decode,
            depth=chunk + 2,
            to_device=False,
            keep_bgr=keep_bgr,
        )
        pts_dev = jax.device_put(jnp.asarray(self.pts, jnp.float32))
        lk, norm, filt = cfg.lk, cfg.norm, cfg.filt

        @jax.jit
        def chunk_fn(frames_u8):
            # packed single-array result: ONE device-to-host transfer per
            # chunk instead of one per result field
            return pack_grid_result(
                lk_grid_flow_video(frames_u8, pts_dev, lk=lk, norm=norm, filt=filt)
            )

        writer = None
        if out_path is not None:
            import cv2 as _cv2

            writer = _cv2.VideoWriter(
                out_path,
                _cv2.VideoWriter_fourcc(*"mp4v"),
                self.reader.fps or 25.0,
                (self.reader.width, self.reader.height),
            )

        # compile outside the clock: the e2e number is steady-state
        # throughput (the reference's FPS overlay also reports post-warmup
        # per-frame rate, pathfinder_viewer.py:339-356)
        jax.block_until_ready(chunk_fn(jnp.zeros((chunk + 1, h, w), jnp.uint8)))
        pts_i = np.trunc(np.asarray(self.pts) + 0.5).astype(np.int32)

        n = 0
        danger_counts = []
        since_save = 0
        t_start = time.time()
        # (device result, bgr pair frames, valid count, last gray, abs
        # index of the frame AFTER this chunk's last pair)
        pending = None

        def consume(p):
            nonlocal n, since_save
            res, bgrs, count, last_gray, abs_end = p
            host = unpack_grid_result(np.asarray(res), pts_i)  # blocks here
            if on_chunk is not None:
                # streaming consumers (e.g. the soak harness) get each
                # chunk's outputs the moment they are consumed — a run
                # killed mid-clip has already exported everything up to
                # its last consumed chunk
                on_chunk(
                    abs_end - count,
                    [int(host.good[i].sum()) for i in range(count)],
                )
            for i in range(count):
                danger_counts.append(int(host.good[i].sum()))
                n += 1
                if writer is not None or render:
                    one = GridFlowResult(*[a[i] for a in host])
                    fps_now = n / max(time.time() - t_start, 1e-9)
                    out = self.render_frame(bgrs[i], one, fps=fps_now)
                    if writer is not None:
                        writer.write(out)
            since_save += count
            if cfg.checkpoint_path and since_save >= cfg.checkpoint_every:
                # atomic (tmp + rename): a kill mid-save leaves the
                # previous checkpoint intact
                save_checkpoint(
                    cfg.checkpoint_path,
                    frame_idx=np.int64(abs_end),
                    prev_gray=np.asarray(last_gray, np.uint8),
                )
                since_save = 0

        def dispatch(grays, bgrs, abs_end):
            nonlocal pending
            valid = len(grays) - 1
            if valid < 1:
                return
            last_gray = grays[-1]
            if valid < chunk:  # pad the tail chunk to avoid a recompile
                grays = grays + [grays[-1]] * (chunk - valid)
            dev = jax.device_put(jnp.asarray(np.stack(grays)))
            res = chunk_fn(dev)  # async dispatch
            prev, pending = pending, (res, bgrs[1:], valid, last_gray, abs_end)
            if prev is not None:
                consume(prev)

        buf_gray: list = []
        buf_bgr: list = []
        abs_next = start_abs  # absolute index of the next decoded frame
        if resume_prev is not None:
            # the checkpointed previous frame seeds the first pair
            buf_gray.append(resume_prev)
            buf_bgr.append(None)
        for item in pre:
            bgr, gray = item if keep_bgr else (None, item)
            buf_gray.append(gray)
            buf_bgr.append(bgr)
            abs_next += 1
            if len(buf_gray) == chunk + 1:
                dispatch(buf_gray, buf_bgr, abs_next)
                buf_gray, buf_bgr = [buf_gray[-1]], [buf_bgr[-1]]
        if len(buf_gray) > 1:
            dispatch(buf_gray, buf_bgr, abs_next)
        if pending is not None:
            consume(pending)
        if writer is not None:
            writer.release()
        wall = time.time() - t_start
        return {
            "frames": n,
            "first_pair_frame": start_abs + (0 if resume_prev is not None else 1),
            "wall_s": wall,
            "fps": n / max(wall, 1e-9),
            "mean_danger_points": float(np.mean(danger_counts)) if danger_counts else 0.0,
            "danger_counts": danger_counts,
        }

    def _handle_key(self, key: int) -> bool:
        """Reference keyboard map (pathfinder_viewer.py:314-337)."""
        import cv2 as _cv2

        cfg = self.cfg
        if key == ord(" "):
            while True:
                k2 = _cv2.waitKey(30) & 0xFF
                if k2 == ord(" "):
                    break
                if k2 in (ord("q"), 27):
                    return False
        if key == ord("1"):
            cfg.add_sparse_flow = not cfg.add_sparse_flow
        if key == ord("2"):
            cfg.add_sparse_lamps = not cfg.add_sparse_lamps
        if key == ord("3"):
            if not cfg.add_sparse_flow:
                cfg.add_sparse_flow = True
            cfg.show_lamps = not cfg.show_lamps
        if key == ord("4"):
            if not cfg.add_sparse_flow:
                cfg.add_sparse_flow = True
            cfg.draw_bad_flow = not cfg.draw_bad_flow
        if key in (ord("q"), 27):
            return False
        return True


def parse_cli(argv: list[str] | None = None):
    """(PathfinderConfig, parsed args) for a command line."""
    import argparse

    p = argparse.ArgumentParser(description="pathfinder viewer")
    p.add_argument("video", help="video file or .npy/.npz frame stack")
    p.add_argument("--out", default=None, help="headless render target mp4")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--step", type=int, default=30)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--no-render", action="store_true")
    p.add_argument(
        "--chunk",
        type=int,
        default=None,
        help="headless chunked pipeline: frame-pairs per device dispatch "
        "(one lax.scan per chunk; decode/compute/fetch overlap)",
    )
    p.add_argument(
        "--checkpoint",
        default=None,
        help="checkpoint file: resumes from it if present; saves "
        "atomically at chunk boundaries (chunked pipeline only)",
    )
    args = p.parse_args(argv)
    cfg = PathfinderConfig(
        video=args.video,
        start_frame=args.start_frame,
        max_frames=args.max_frames,
        step=args.step,
        checkpoint_path=args.checkpoint,
        # the pipeline never reads LK's residual err
        lk=LKParams(compute_err=False),
    )
    return cfg, args


def run_cli(cfg: PathfinderConfig, args) -> dict:
    """Run the app the way the command line asks; returns its stats."""
    app = PathfinderApp(cfg)
    if args.chunk and not args.interactive:
        return app.run_batched(
            chunk=args.chunk, out_path=args.out, render=not args.no_render
        )
    return app.run(
        headless=not args.interactive, out_path=args.out, render=not args.no_render
    )


def main(argv: list[str] | None = None) -> None:
    enable_compile_cache()
    stats = run_cli(*parse_cli(argv))
    stats.pop("danger_counts", None)
    print(stats)


if __name__ == "__main__":
    main()
