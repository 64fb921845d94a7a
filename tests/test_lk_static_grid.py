"""Measurement-grid LK: the grid's point order and the production
configuration's danger-mask parity with the cv2 pipeline (reference
get_flow_lk, pathfinder_viewer.py:144-193, win 45x45 maxLevel 2)."""

import numpy as np

import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import LKParams
from hackathonopticalflow_tpu.core.grid import measurement_grid
from hackathonopticalflow_tpu.ops.lk import pyr_lk

from conftest import requires_cv2, HAVE_CV2

if HAVE_CV2:
    import cv2


def _grid_xy(h, w, step=30):
    pts = measurement_grid(h, w, step)
    return pts, np.unique(pts[:, 0]).astype(int), np.unique(pts[:, 1]).astype(int)


def test_static_grid_point_order():
    """Grid x-major point order must round-trip through the extractors."""
    h, w = 270, 480
    pts, xs, ys = _grid_xy(h, w)
    idx = np.stack(np.meshgrid(np.arange(len(xs)), np.arange(len(ys)), indexing="ij"), -1)
    flat = idx.reshape(-1, 2)
    recon = np.stack([xs[flat[:, 0]], ys[flat[:, 1]]], axis=-1)
    assert np.array_equal(recon, pts.astype(int))


@requires_cv2
def test_production_config_danger_mask_parity(frame_pair):
    """At the production configuration (1080p, grid 30, LKParams defaults
    with err off) the danger mask agrees with the cv2 pipeline on >= 99.5%
    of points and the status bits on >= 99.9%, on the seeded 1080p pair
    (expansion, drift and two discs moving > 40 px)."""
    a, b = frame_pair
    h, w = a.shape
    pts, xs, ys = _grid_xy(h, w)
    new = pyr_lk(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
        jnp.asarray(pts), LKParams(compute_err=False),
    )
    nxt, st, _ = cv2.calcOpticalFlowPyrLK(
        a, b, pts.reshape(-1, 1, 2), None, winSize=(45, 45), maxLevel=2,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 10, 0.03),
    )
    nxt = nxt.reshape(-1, 2)
    p = np.asarray(new.next_pts)

    def mask(endpoints):
        f = endpoints - pts
        m = np.linalg.norm(f, axis=-1)
        dc = np.linalg.norm(pts - [w / 2, h / 2], axis=-1)
        m = m / (5 + np.sqrt(dc)) * 30
        return (np.median(m) < m) & (m < np.percentile(m, 99))

    assert np.mean(mask(p) == mask(nxt)) >= 0.995
    assert np.mean(np.asarray(new.status) == (st.reshape(-1) > 0)) >= 0.999
