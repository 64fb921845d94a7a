"""Pytree/dataclass configs for every algorithm stage.

The reference hardcodes these constants inline; here they are explicit,
hashable (usable as jit static args), and documented with the reference
call sites they mirror:

- LK window/criteria: reference pathfinder_viewer.py:154-158 (win 45x45,
  maxLevel 2, up to 10 iterations, eps 0.03) and SparseOF.py:6-8
  (win 15x15 for the trajectory tracker).
- Farneback defaults: reference DenseOF.py:127-157 (pyr_scale 0.5, levels 3,
  winsize 15, iterations 3, poly_n 5, poly_sigma 1.2).
- Shi-Tomasi feature params: reference SparseOF.py:10-13.
- Tracker params: reference SparseOF.py:15-16,37-38 (trajectory_len 40,
  detect_interval 5, forward-backward gate d < 1 px).
- Radial normalization constants 5/30: reference pathfinder_viewer.py:166.
- Filter thresholds: reference pathfinder_viewer.py:173 (median*1.0 lower,
  P99 upper) and DenseOF.py:228 (median*1.2, no upper bound).
- Grid step 30: reference pathfinder_viewer.py:16.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LKParams:
    """Pyramidal Lucas-Kanade parameters (cv2.calcOpticalFlowPyrLK parity).

    slab_margin: None -> exact per-iteration window sampling (OpenCV
    parity, unbounded displacement; on CUDA the per-level loop runs as
    the Triton kernel in ops/lk_triton.py). An int M -> one
    (win+2M+2)^2 slab is extracted per point per level and the iteration
    windows are selected from it with masked static slices (plain XLA).
    Points whose intra-level displacement exceeds M px clamp to the slab
    edge — in practice only points already beyond LK's trackable range
    (window/2 per level), which the reference's own filters discard."""

    win_size: tuple[int, int] = (45, 45)  # (w, h)
    max_level: int = 2
    max_iters: int = 10
    eps: float = 0.03
    min_eig_threshold: float = 1e-4
    slab_margin: int | None = None
    #: compute the per-point residual err output at level 0 (OpenCV's err;
    #: the reference pipeline never reads it, so the pathfinder CLI and
    #: the benchmark turn it off).
    compute_err: bool = True

    @property
    def win_area(self) -> int:
        return self.win_size[0] * self.win_size[1]


#: Tracker-flavoured LK (reference SparseOF.py:6-8).
TRACKER_LK = LKParams(win_size=(15, 15), max_level=2, max_iters=10, eps=0.03)


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Farneback dense-flow parameters (cv2.calcOpticalFlowFarneback parity).

    warp_mode selects how the second frame's polynomial coefficients are
    displaced by the current flow each iteration:
      - "exact" (default): bilinear warp of the 5 coefficient channels —
        OpenCV semantics, ~1e-5 px EPE vs cv2 (the golden-test path);
      - "image": warp the grayscale image once per iteration and re-expand
        — 5x fewer gathered elements, first-order-equivalent for locally
        smooth flow; EPE vs cv2 stays well inside the 0.5 px budget;
      - "hybrid": image-mode warps for the early iterations, exact
        coefficient warp for each level's final matrix update;
      - "packed": exact semantics with bf16-pair coefficient gathers
        (12 elements/px instead of 20, ~1e-3 px EPE).
    """

    pyr_scale: float = 0.5
    levels: int = 3
    win_size: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    gaussian_win: bool = False  # flags=0 in the reference -> box filter
    warp_mode: str = "exact"


@dataclasses.dataclass(frozen=True)
class FeatureParams:
    """Shi-Tomasi corner detection (cv2.goodFeaturesToTrack parity)."""

    max_corners: int = 20
    quality_level: float = 0.3
    min_distance: float = 10.0
    block_size: int = 7
    # implementation knob: how many NMS survivors to consider before the
    # greedy min-distance pass (static shape for jit)
    max_candidates: int = 512


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """Forward-backward LK trajectory tracker (reference SparseOF.py)."""

    lk: LKParams = TRACKER_LK
    trajectory_len: int = 40
    detect_interval: int = 5
    fb_max_dist: float = 1.0  # forward-backward gate, SparseOF.py:37-38
    max_tracks: int = 256  # static capacity of the functional track table
    features: FeatureParams = FeatureParams()


@dataclasses.dataclass(frozen=True)
class NormalizeParams:
    """Radial (focus-of-expansion) magnitude normalization.

    modulus <- modulus / (offset + sqrt(dist_to_center)) * gain
    (reference pathfinder_viewer.py:164-166)
    """

    offset: float = 5.0
    gain: float = 30.0


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Robust statistical vector filter.

    Viewer variant keeps  median*median_factor < m < P(upper_percentile)
    (reference pathfinder_viewer.py:173); the DenseOF prototype uses
    median*1.2 with no upper bound (DenseOF.py:228).
    """

    median_factor: float = 1.0
    upper_percentile: float | None = 99.0


#: DenseOF.py:228 variant.
PROTO_FILTER = FilterParams(median_factor=1.2, upper_percentile=None)


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Centered measurement grid (reference pathfinder_viewer.py:255-267)."""

    step: int = 30
