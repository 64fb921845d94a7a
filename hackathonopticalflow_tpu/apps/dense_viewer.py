"""Dense-flow viewer — a re-design of DenseOF.py:443-672.

Per frame: Farneback dense flow and/or grid LK on device; host-side layer
compositing with the prototype's display modes (gray/RGB/R/G/B/HSV/H/S/V
cycled by `` ` ``), flow glyphs, HSV wheel, danger lamps, contours window,
and the reference keyboard map (1-7, space, q)."""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import FarnebackParams, FilterParams, LKParams, NormalizeParams, PROTO_FILTER
from ..core.grid import measurement_grid
from ..flow.dense import farneback_flow
from ..flow.lk_grid import lk_grid_flow
from ..io.video import VideoReader
from ..utils.compile_cache import enable_compile_cache
from ..io import native_lib
from ..ops.image import threshold_binary
from ..viz.draw import add_layers, put_text, polylines
from ..viz.layers import draw_flow, draw_grid, draw_grid_vectors, draw_hsv, draw_sparse_lamps

#: display modes (DenseOF.py:486-488): 0 gray, 1 RGB, 2 R, 3 G, 4 B,
#: 5 HSV, 6 H, 7 S, 8 V
DEFAULT_MODES = [0, 1, 6, 7, 8]


@dataclasses.dataclass
class DenseViewerConfig:
    video: str
    add_flow: bool = False  # DenseOF.py:7
    add_sparse_flow: bool = True  # :8
    add_hsv: bool = False  # :9
    show_hsv: bool = False  # :10
    show_contours: bool = False  # :11
    add_sparse_hsv: bool = True  # :12 (rendered as lamps, like the proto)
    start_frame: int = 0
    step: int = 30
    max_frames: int | None = None
    viewing_angle: float = 155.0
    fb: FarnebackParams = FarnebackParams()
    lk: LKParams = LKParams()
    filt: FilterParams = PROTO_FILTER  # DenseOF.py:228 variant
    contour_div: int = 63  # DenseOF.py:377
    contour_length: int = 150  # DenseOF.py:323


def render_mode(img: np.ndarray, mode: int) -> tuple[np.ndarray, str]:
    """The 9 channel views (DenseOF.py:530-570)."""
    import cv2

    z = np.zeros(img.shape[:2], np.uint8)
    if mode == 0:
        g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return cv2.merge([g, g, g]), "gray"
    if mode == 1:
        return img, "RGB"
    if mode in (2, 3, 4):
        ch = img[:, :, {2: 2, 3: 1, 4: 0}[mode]]
        layers = {2: [z, z, ch], 3: [z, ch, z], 4: [ch, z, z]}[mode]
        return cv2.merge(layers), {2: "R", 3: "G", 4: "B"}[mode]
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    if mode == 5:
        return hsv, "HSV"
    ch = hsv[:, :, mode - 6]
    return cv2.merge([ch, ch, ch]), {6: "H", 7: "S", 8: "V"}[mode]


def contour_layer(gray: np.ndarray, div: int = 63, contour_length: int = 150) -> np.ndarray:
    """Obstacle-outline layer (DenseOF.py:320-440): gray quantization,
    per-level binary threshold, native border following, length filter,
    white/red contour rendering."""
    h, w = gray.shape
    layer = np.zeros((h, w, 3), np.uint8)
    levels = sorted({(p // div) * div for p in range(0, 255)})
    img_div = (gray // div) * div
    for color in levels:
        binary = np.asarray(threshold_binary(jnp.asarray(img_div, jnp.float32), float(color)))
        contours = native_lib.trace_contours(binary.astype(np.uint8))
        long_c = [c for c in contours if len(c) > contour_length]
        short_c = [
            c for c in contours if contour_length * 0.8 < len(c) <= contour_length
        ]
        polylines(layer, long_c, (255, 255, 255), 1)
        polylines(layer, short_c, (0, 0, 255), 1)
    return layer


class DenseViewerApp:
    def __init__(self, cfg: DenseViewerConfig):
        self.cfg = cfg
        self.reader = VideoReader(cfg.video)
        h, w = self.reader.height, self.reader.width
        self.pts = measurement_grid(h, w, cfg.step)
        self._dense_fn = jax.jit(functools.partial(farneback_flow, params=cfg.fb))
        self._sparse_fn = jax.jit(
            functools.partial(lk_grid_flow, lk=cfg.lk, filt=cfg.filt)
        )

    def run(self, headless: bool = True, out_path: str | None = None) -> dict:
        import cv2

        cfg = self.cfg
        reader = self.reader
        if cfg.start_frame:
            reader.seek(cfg.start_frame)
        prev = reader.read()
        if prev is None:
            raise IOError("no first frame")
        prev_gray = cv2.cvtColor(prev, cv2.COLOR_BGR2GRAY)
        writer = None
        if out_path:
            writer = cv2.VideoWriter(
                out_path,
                cv2.VideoWriter_fourcc(*"mp4v"),
                reader.fps or 25.0,
                (reader.width, reader.height),
            )
        mode_iter = iter(DEFAULT_MODES)
        mode = next(mode_iter)
        n = 0
        t_start = time.time()
        while cfg.max_frames is None or n < cfg.max_frames:
            frame = reader.read()
            if frame is None:
                break
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            h, w = gray.shape

            # uint8 across the host->device link; ops cast on device
            flow = None
            if cfg.add_flow or cfg.add_hsv or cfg.show_hsv:
                flow = self._dense_fn(jnp.asarray(prev_gray), jnp.asarray(gray))
            sres = None
            if cfg.add_sparse_flow or cfg.add_sparse_hsv:
                sres = self._sparse_fn(
                    jnp.asarray(prev_gray), jnp.asarray(gray), self.pts
                )
            prev_gray = gray

            out, mode_name = render_mode(frame, mode)
            layers = [out]
            if cfg.add_flow and flow is not None:
                layers.append(draw_flow((h, w), flow))
            if cfg.add_sparse_flow and sres is not None:
                layers.append(
                    draw_grid_vectors(
                        (h, w), np.asarray(sres.pts), np.asarray(sres.next_pts),
                        np.asarray(sres.good), draw_bad=True,
                    )
                )
            if cfg.add_hsv and flow is not None:
                layers.append(draw_hsv(np.asarray(flow)))
            if cfg.add_sparse_hsv and sres is not None:
                good = np.asarray(sres.good)
                layers.append(
                    draw_sparse_lamps(
                        (h, w),
                        np.asarray(sres.flow)[good],
                        np.asarray(sres.pts)[good],
                    )
                )
            out = add_layers(*layers)
            out = add_layers(
                out,
                draw_grid((h, w), 20, colored_cross=True, viewing_angle_rect=True,
                          cross=True, blinds=True, viewing_angle=cfg.viewing_angle),
            )
            put_text(out, mode_name, (20, 150))
            fps = (n + 1) / max(time.time() - t_start, 1e-9)
            put_text(out, f"{fps:.2f} FPS", (20, 30))
            if cfg.show_contours:
                cl = contour_layer(gray, cfg.contour_div, cfg.contour_length)
                if not headless:
                    cv2.imshow("contours", cl)
            if cfg.show_hsv and flow is not None and not headless:
                cv2.imshow("flow HSV", draw_hsv(np.asarray(flow)))
            if writer:
                writer.write(out)
            if not headless:
                cv2.imshow("flow", out)
                key = cv2.waitKey(1) & 0xFF
                if key in (ord("q"), 27):
                    break
                if key == ord("`"):
                    try:
                        mode = next(mode_iter)
                    except StopIteration:
                        mode_iter = iter(DEFAULT_MODES)
                        mode = next(mode_iter)
                if key == ord("1"):
                    cfg.add_flow = not cfg.add_flow
                if key == ord("2"):
                    cfg.add_hsv = not cfg.add_hsv
                if key == ord("3"):
                    cfg.show_hsv = not cfg.show_hsv
                if key == ord("4"):
                    cfg.show_contours = not cfg.show_contours
                if key == ord("5"):
                    cfg.add_sparse_flow = not cfg.add_sparse_flow
                if key == ord("6"):
                    cfg.add_sparse_hsv = not cfg.add_sparse_hsv
            n += 1
        if writer:
            writer.release()
        wall = time.time() - t_start
        return {"frames": n, "wall_s": wall, "fps": n / max(wall, 1e-9)}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="dense-flow viewer")
    p.add_argument("video")
    p.add_argument("--out", default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--dense", action="store_true", help="enable Farneback flow layer")
    p.add_argument("--contours", action="store_true")
    p.add_argument("--interactive", action="store_true")
    args = p.parse_args(argv)
    enable_compile_cache()
    cfg = DenseViewerConfig(
        video=args.video,
        max_frames=args.max_frames,
        start_frame=args.start_frame,
        add_flow=args.dense,
        add_hsv=args.dense,
        show_contours=args.contours,
    )
    print(DenseViewerApp(cfg).run(headless=not args.interactive, out_path=args.out))


if __name__ == "__main__":
    main()
