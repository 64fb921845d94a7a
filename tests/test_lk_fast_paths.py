"""The LK slab path and the whole-clip scan must match the exact
OpenCV-parity path."""

import numpy as np
import pytest

import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import LKParams
from hackathonopticalflow_tpu.core.grid import measurement_grid
from hackathonopticalflow_tpu.ops.lk import pyr_lk


@pytest.fixture(scope="module")
def pair_and_pts(frame_pair_small):
    a, b = frame_pair_small
    return a, b, measurement_grid(270, 480, 30)


def _epe_vs_exact(a, b, pts, params):
    af, bf = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
    exact = pyr_lk(af, bf, jnp.asarray(pts), LKParams())
    fast = pyr_lk(af, bf, jnp.asarray(pts), params)
    st = np.asarray(exact.status)
    d = np.linalg.norm(np.asarray(exact.next_pts) - np.asarray(fast.next_pts), axis=-1)
    agree = (st == np.asarray(fast.status)).mean()
    return d[st], agree


def test_slab_path_matches_exact(pair_and_pts):
    a, b, pts = pair_and_pts
    d, agree = _epe_vs_exact(a, b, pts, LKParams(slab_margin=16))
    assert agree > 0.99
    assert d.mean() < 1e-3
    assert d.max() < 0.05


def test_video_scan_matches_per_pair(pair_and_pts):
    """lk_grid_flow_video must equal per-pair lk_grid_flow calls."""
    import jax

    from hackathonopticalflow_tpu.flow.lk_grid import lk_grid_flow, lk_grid_flow_video

    a, b, pts = pair_and_pts
    frames = np.stack([a, b, a]).astype(np.float32)
    params = LKParams(win_size=(21, 21), max_level=1, max_iters=5)
    vid = jax.jit(lambda f, p: lk_grid_flow_video(f, p, lk=params))(
        jnp.asarray(frames), jnp.asarray(pts)
    )
    for t in range(2):
        ref = lk_grid_flow(
            jnp.asarray(frames[t]), jnp.asarray(frames[t + 1]), jnp.asarray(pts), lk=params
        )
        np.testing.assert_allclose(
            np.asarray(vid.next_pts[t]), np.asarray(ref.next_pts), atol=1e-4
        )
        np.testing.assert_array_equal(np.asarray(vid.good[t]), np.asarray(ref.good))
