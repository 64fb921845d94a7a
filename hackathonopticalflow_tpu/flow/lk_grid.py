"""Grid-point LK flow with radial normalization and robust filtering —
the jittable contract of the reference's `get_flow_lk`
(pathfinder_viewer.py:144-193).

Faithful pipeline, with exact constants:

1. backward pyramidal LK: flow measured current -> previous frame
   (the reference passes `(img2, img1)` at pathfinder_viewer.py:156);
2. magnitude/angle decomposition; radial normalization
   m <- m / (5 + sqrt(dist_to_center)) * 30 (:164-166);
3. reconstructed endpoints, reference rounding int32(x + 0.5)
   (truncation toward zero after +0.5, :170-171);
4. robust mask median*1.0 < m < P99 (:173) — or the DenseOF.py:228
   variant via FilterParams.

jit-friendly: returns ALL points with a good/bad mask instead of ragged
compaction (hosts compact for drawing).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import FilterParams, LKParams, NormalizeParams
from ..nav.normalize import radial_normalize
from ..nav.filter import robust_mask
from ..ops.lk import pyr_lk


class GridFlowResult(NamedTuple):
    raw_next_pts: jnp.ndarray  # (N, 2) float32 — LK output before normalize
    flow: jnp.ndarray  # (N, 2) int32 — normalized rounded endpoint - point
    next_pts: jnp.ndarray  # (N, 2) int32 — normalized rounded endpoints
    pts: jnp.ndarray  # (N, 2) int32 — rounded measurement points
    modulus: jnp.ndarray  # (N,) float32 — normalized magnitudes
    ang: jnp.ndarray  # (N,) float32 — flow angles
    good: jnp.ndarray  # (N,) bool — passed the robust filter
    status: jnp.ndarray  # (N,) bool — LK track status


def _round_ref(x: jnp.ndarray) -> jnp.ndarray:
    """np.int32(x + 0.5) parity: add 0.5 then truncate toward zero."""
    return jnp.trunc(x + 0.5).astype(jnp.int32)


def pack_grid_result(res: GridFlowResult) -> jnp.ndarray:
    """Flatten a batched (T-frame) GridFlowResult into ONE (T, 10*N)
    float32 array so streaming consumers pay a SINGLE device-to-host
    transfer per chunk instead of one per field. `pts` is excluded: it
    is the constant measurement grid the caller already holds."""
    t = res.modulus.shape[0]
    f32 = jnp.float32
    # int32 fields round-trip through f32: exact only for |v| < 2^24 —
    # fine for pixel coordinates/flows, do not reuse for larger ints
    return jnp.concatenate(
        [
            res.raw_next_pts.reshape(t, -1),
            res.flow.astype(f32).reshape(t, -1),
            res.next_pts.astype(f32).reshape(t, -1),
            res.modulus,
            res.ang,
            res.good.astype(f32),
            res.status.astype(f32),
        ],
        axis=1,
    )


def unpack_grid_result(packed, pts_i) -> GridFlowResult:
    """Host-side inverse of pack_grid_result. `packed` is the fetched
    (T, 10*N) numpy array; `pts_i` the (N, 2) int32 rounded grid."""
    import numpy as np

    t = packed.shape[0]
    n = pts_i.shape[0]
    o = [0, 2 * n, 4 * n, 6 * n, 7 * n, 8 * n, 9 * n, 10 * n]
    return GridFlowResult(
        raw_next_pts=packed[:, o[0] : o[1]].reshape(t, n, 2),
        flow=packed[:, o[1] : o[2]].reshape(t, n, 2).astype(np.int32),
        next_pts=packed[:, o[2] : o[3]].reshape(t, n, 2).astype(np.int32),
        # materialize (not a zero-strided broadcast view) so consumers can
        # mutate or hand the field to APIs needing a writable buffer
        pts=np.ascontiguousarray(np.broadcast_to(pts_i, (t, n, 2))),
        modulus=packed[:, o[3] : o[4]],
        ang=packed[:, o[4] : o[5]],
        good=packed[:, o[5] : o[6]] != 0.0,
        status=packed[:, o[6] : o[7]] != 0.0,
    )


def lk_grid_flow(
    prev_gray: jnp.ndarray,
    gray: jnp.ndarray,
    pts: jnp.ndarray,
    lk: LKParams = LKParams(),
    norm: NormalizeParams = NormalizeParams(),
    filt: FilterParams = FilterParams(),
) -> GridFlowResult:
    """prev_gray/gray: (H, W) grayscale in [0, 255] (uint8 welcome — apps
    transfer u8 and the cast happens on device); pts: (N, 2)."""
    prev_gray = prev_gray.astype(jnp.float32)
    gray = gray.astype(jnp.float32)
    h, w = gray.shape
    # backward flow: track grid points from current frame into previous
    res = pyr_lk(gray, prev_gray, pts, lk)
    return _post_lk(res, pts, h, w, norm, filt)


def lk_grid_flow_video(
    frames: jnp.ndarray,
    pts: jnp.ndarray,
    lk: LKParams = LKParams(),
    norm: NormalizeParams = NormalizeParams(),
    filt: FilterParams = FilterParams(),
) -> GridFlowResult:
    """Whole-clip form: (T, H, W) frames -> GridFlowResult batched over the
    T-1 frame steps, via one lax.scan that carries each frame's prepared
    pyramid (each frame is prepared ONCE, not twice — the per-frame
    pyramid/derivative/pad work halves vs calling lk_grid_flow per pair).
    This is the device-resident shape benchmarks and batch apps use."""
    from ..ops.lk import prepare_frame, pyr_lk_prepared

    h, w = frames.shape[-2:]
    frames = frames.astype(jnp.float32)
    pts = pts.astype(jnp.float32)
    prep0 = prepare_frame(frames[0], lk)

    def step(prev_prep, img):
        cur_prep = prepare_frame(img, lk)
        # viewer semantics: current frame is the LK template source
        res = pyr_lk_prepared(cur_prep, prev_prep, pts, lk)
        return cur_prep, _post_lk(res, pts, h, w, norm, filt)

    _, results = jax.lax.scan(step, prep0, frames[1:])
    return results


def _post_lk(
    res,
    pts: jnp.ndarray,
    h: int,
    w: int,
    norm: NormalizeParams,
    filt: FilterParams,
) -> GridFlowResult:
    """Radial normalization + robust filtering + reference rounding
    (pathfinder_viewer.py:159-176) applied to an LK result."""
    half_w = int(w / 2)
    half_h = int(h / 2)
    flow_raw = res.next_pts - pts
    fx, fy = flow_raw[:, 0], flow_raw[:, 1]
    x, y = pts[:, 0], pts[:, 1]
    ang = jnp.arctan2(fy, fx)
    modulus = jnp.sqrt(fx * fx + fy * fy)
    modulus = radial_normalize(modulus, x, y, half_w, half_h, norm)
    nfx = modulus * jnp.cos(ang)
    nfy = modulus * jnp.sin(ang)
    next_pts = _round_ref(jnp.stack([x + nfx, y + nfy], axis=-1))
    pts_i = _round_ref(pts)
    good = robust_mask(modulus, filt)
    return GridFlowResult(
        raw_next_pts=res.next_pts,
        flow=next_pts - pts_i,
        next_pts=next_pts,
        pts=pts_i,
        modulus=modulus,
        ang=ang,
        good=good,
        status=res.status,
    )
