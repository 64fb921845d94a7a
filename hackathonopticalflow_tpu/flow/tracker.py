"""Shi-Tomasi + forward-backward LK trajectory tracker.

A re-design of the reference tracker loop (SparseOF.py:22-92):
per frame, track each live trajectory's head forward with pyramidal LK,
re-track backward, keep tracks whose forward-backward error is < 1 px
(SparseOF.py:35-38 — the reference's only accuracy self-check), append
the new head (trajectory length capped at 40, SparseOF.py:47-48), and
every 5th frame detect new Shi-Tomasi corners away from live tracks
(radius-5 exclusion mask, SparseOF.py:60-73).

Where the reference uses Python lists of variable-length trajectories,
this version is a fixed-capacity functional state (static shapes, scan-
friendly): a (max_tracks, trajectory_len, 2) position table with per-track
lengths and liveness. The whole step is one jittable function — the hot
loop never leaves the device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.config import TrackerParams
from ..ops.features import good_features_to_track
from ..ops.lk import prepare_frame, pyr_lk_prepared


class TrackerState(NamedTuple):
    traj: jnp.ndarray  # (T, L, 2) float32 — trajectory positions
    length: jnp.ndarray  # (T,) int32 — valid entries per trajectory
    alive: jnp.ndarray  # (T,) bool
    frame_idx: jnp.ndarray  # () int32


def init_tracker(params: TrackerParams = TrackerParams()) -> TrackerState:
    t, l = params.max_tracks, params.trajectory_len
    return TrackerState(
        traj=jnp.zeros((t, l, 2), jnp.float32),
        length=jnp.zeros((t,), jnp.int32),
        alive=jnp.zeros((t,), bool),
        frame_idx=jnp.int32(0),
    )


def _heads(state: TrackerState) -> jnp.ndarray:
    """Last valid point of each trajectory (undefined where not alive)."""
    idx = jnp.clip(state.length - 1, 0, state.traj.shape[1] - 1)
    return state.traj[jnp.arange(state.traj.shape[0]), idx]


def _detect_mask(
    heads: jnp.ndarray, alive: jnp.ndarray, h: int, w: int, radius: int = 5
) -> jnp.ndarray:
    """255-filled mask with radius-5 zero circles at live track heads
    (SparseOF.py:61-66)."""
    mask = jnp.ones((h, w), jnp.uint8) * 255
    r = radius
    dy, dx = jnp.meshgrid(
        jnp.arange(-r, r + 1), jnp.arange(-r, r + 1), indexing="ij"
    )
    inside = (dx * dx + dy * dy) <= r * r
    hx = jnp.round(heads[:, 0]).astype(jnp.int32)
    hy = jnp.round(heads[:, 1]).astype(jnp.int32)
    ys = jnp.clip(hy[:, None, None] + dy[None], 0, h - 1)
    xs = jnp.clip(hx[:, None, None] + dx[None], 0, w - 1)
    val = jnp.where(alive[:, None, None] & inside[None], 0, 255).astype(jnp.uint8)
    return mask.at[ys, xs].min(val)


def _append(state: TrackerState, new_heads: jnp.ndarray, keep: jnp.ndarray) -> TrackerState:
    """Append new_heads to kept trajectories (shift-left at capacity)."""
    l = state.traj.shape[1]
    at_cap = state.length >= l
    shifted = jnp.roll(state.traj, -1, axis=1)
    traj = jnp.where((keep & at_cap)[:, None, None], shifted, state.traj)
    idx = jnp.clip(jnp.where(at_cap, l - 1, state.length), 0, l - 1)
    updated = traj.at[jnp.arange(traj.shape[0]), idx].set(new_heads)
    traj = jnp.where(keep[:, None, None], updated, traj)
    length = jnp.where(keep, jnp.minimum(state.length + 1, l), state.length)
    return state._replace(traj=traj, length=length, alive=keep)


def _spawn(state: TrackerState, corners, params: TrackerParams) -> TrackerState:
    """Seed new single-point trajectories in free slots."""
    t = state.traj.shape[0]
    # free slots in ascending index order (False sorts before True)
    order = jnp.argsort(state.alive.astype(jnp.int32), stable=True)
    n_free = jnp.sum(~state.alive)
    k = corners.pts.shape[0]
    slots = order[:k]
    take = corners.valid & (jnp.arange(k) < n_free)
    slot_safe = jnp.where(take, slots, t - 1)  # dummy writes masked below

    traj = state.traj
    length = state.length
    alive = state.alive
    new_pt = corners.pts
    traj = traj.at[slot_safe, 0].set(
        jnp.where(take[:, None], new_pt, traj[slot_safe, 0])
    )
    length = length.at[slot_safe].set(jnp.where(take, 1, length[slot_safe]))
    alive = alive.at[slot_safe].set(jnp.where(take, True, alive[slot_safe]))
    return state._replace(traj=traj, length=length, alive=alive)


def track_video(
    frames: jnp.ndarray,
    params: TrackerParams = TrackerParams(),
    state: TrackerState | None = None,
) -> tuple[TrackerState, tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """lax.scan of track_step over a device-resident clip (F, H, W).

    The reference loop (SparseOF.py:22-92) runs one step per frame; one
    scan amortizes the dispatch over the whole chunk.

    Starts tracking at frames[0] -> frames[1] (seed detections by
    stepping (f0, f0) first, as collect_tracks does). Returns the final
    state and per-frame history rows (heads (F-1, T, 2),
    alive (F-1, T), length (F-1, T)) for frames[1:].
    """
    if state is None:
        state = init_tracker(params)

    # carry each frame's prepared pyramid through the scan: the naive
    # per-step form prepared every frame FOUR times (both pyr_lk calls
    # prep both arguments) — at small track counts the pyramid/Scharr/pad
    # work dominates the whole step
    prep0 = prepare_frame(frames[0].astype(jnp.float32), params.lk)

    def step(carry, img):
        s, prev_prep = carry
        img = img.astype(jnp.float32)
        cur_prep = prepare_frame(img, params.lk)
        s2 = track_step_prepared(s, prev_prep, cur_prep, img, params)
        return (s2, cur_prep), (_heads(s2), s2.alive, s2.length)

    (state, _), hist = lax.scan(step, (state, prep0), frames[1:])
    return state, hist


def track_step(
    state: TrackerState,
    prev_gray: jnp.ndarray,
    gray: jnp.ndarray,
    params: TrackerParams = TrackerParams(),
) -> TrackerState:
    """One frame of tracking: forward-backward LK + gated append +
    periodic re-detection. Fully jittable. Each frame's pyramid is
    prepared once and shared by the forward and backward LK calls."""
    prev_gray = prev_gray.astype(jnp.float32)
    gray = gray.astype(jnp.float32)
    prev_prep = prepare_frame(prev_gray, params.lk)
    cur_prep = prepare_frame(gray, params.lk)
    return track_step_prepared(state, prev_prep, cur_prep, gray, params)


def track_step_prepared(
    state: TrackerState,
    prev_prep,
    cur_prep,
    gray: jnp.ndarray,
    params: TrackerParams = TrackerParams(),
) -> TrackerState:
    """track_step over frames prepared with ops.lk.prepare_frame — the
    form track_video's scan uses so each frame is prepared once per
    CLIP, not four times per step."""
    h, w = gray.shape
    heads = _heads(state)

    p1 = pyr_lk_prepared(prev_prep, cur_prep, heads, params.lk).next_pts
    p0r = pyr_lk_prepared(cur_prep, prev_prep, p1, params.lk).next_pts
    d = jnp.max(jnp.abs(heads - p0r), axis=-1)
    keep = state.alive & (d < params.fb_max_dist)
    state = _append(state, p1, keep)

    def with_detect(state):
        mask = _detect_mask(_heads(state), state.alive, h, w)
        corners = good_features_to_track(gray, params.features, mask=mask)
        return _spawn(state, corners, params)

    state = lax.cond(
        state.frame_idx % params.detect_interval == 0,
        with_detect,
        lambda s: s,
        state,
    )
    return state._replace(frame_idx=state.frame_idx + 1)
