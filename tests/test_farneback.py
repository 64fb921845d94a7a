"""Farneback dense flow golden tests vs cv2.calcOpticalFlowFarneback
(the reference's dense kernel, DenseOF.py:127-157).

The XLA implementation matches OpenCV to ~1e-5 px mean EPE on real flight
frames — far inside the 0.5 px budget from BASELINE.json."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import FarnebackParams
from hackathonopticalflow_tpu.ops.farneback import farneback, poly_exp
from hackathonopticalflow_tpu.flow.dense import farneback_flow

from conftest import requires_cv2, HAVE_CV2

if HAVE_CV2:
    import cv2


@requires_cv2
def test_farneback_reference_config_golden(frame_pair_small):
    """The exact reference configuration (DenseOF.py:147-157)."""
    a, b = frame_pair_small
    ref = cv2.calcOpticalFlowFarneback(a, b, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    ours = np.asarray(
        jax.jit(lambda x, y: farneback(x, y, FarnebackParams()))(
            a.astype(np.float32), b.astype(np.float32)
        )
    )
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 1e-3
    assert epe.max() < 0.05


@requires_cv2
@pytest.mark.parametrize("levels,win,iters", [(1, 7, 1), (2, 21, 2)])
def test_farneback_other_configs(frame_pair_small, levels, win, iters):
    a, b = frame_pair_small
    ref = cv2.calcOpticalFlowFarneback(a, b, None, 0.5, levels, win, iters, 5, 1.2, 0)
    ours = np.asarray(
        farneback(
            jnp.asarray(a, jnp.float32),
            jnp.asarray(b, jnp.float32),
            FarnebackParams(levels=levels, win_size=win, iterations=iters),
        )
    )
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 1e-2
    assert epe.max() < 0.5


def test_poly_exp_recovers_quadratic():
    """Polynomial expansion must exactly fit a quadratic surface."""
    h, w = 64, 64
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    c, bx, by, axx, ayy, axy = 7.0, 0.3, -0.2, 0.01, 0.02, -0.005
    img = c + bx * xs + by * ys + axx * xs**2 + ayy * ys**2 + axy * xs * ys
    R = np.asarray(poly_exp(jnp.asarray(img), 5, 1.2))
    x0, y0 = 32, 30
    assert abs(R[0, y0, x0] - (by + 2 * ayy * y0 + axy * x0)) < 1e-2
    assert abs(R[1, y0, x0] - (bx + 2 * axx * x0 + axy * y0)) < 1e-2
    assert abs(R[2, y0, x0] - ayy) < 1e-4
    assert abs(R[3, y0, x0] - axx) < 1e-4
    assert abs(R[4, y0, x0] - axy) < 1e-4


def test_farneback_flow_batched():
    """flow/dense.py vmaps leading batch dims (the stream-DP contract)."""
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 255, (2, 48, 64)).astype(np.float32)
    b = np.roll(a, 1, axis=-1)
    out = farneback_flow(jnp.asarray(a), jnp.asarray(b), FarnebackParams(levels=1))
    assert out.shape == (2, 48, 64, 2)
    single = farneback_flow(jnp.asarray(a[0]), jnp.asarray(b[0]), FarnebackParams(levels=1))
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(single), atol=1e-5)


def test_farneback_video_scan_matches_pairwise():
    """farneback_flow_video (prepared-frame scan: each frame's poly
    pyramid built once) must equal per-pair farneback exactly."""
    from hackathonopticalflow_tpu.flow.dense import farneback_flow_video

    from hackathonopticalflow_tpu.ops.farneback import (
        farneback_prepared,
        prepare_frame,
    )

    rng = np.random.RandomState(1)
    frames = rng.uniform(0, 255, (4, 48, 64)).astype(np.float32)
    params = FarnebackParams(levels=2)
    flows = np.asarray(
        jax.jit(lambda f: farneback_flow_video(f, params))(jnp.asarray(frames))
    )
    assert flows.shape == (3, 48, 64, 2)
    for t in range(3):
        ref = np.asarray(
            farneback(jnp.asarray(frames[t]), jnp.asarray(frames[t + 1]), params)
        )
        # prepared-path math is EXACTLY the pairwise math...
        direct = np.asarray(
            farneback_prepared(
                prepare_frame(jnp.asarray(frames[t]), params),
                prepare_frame(jnp.asarray(frames[t + 1]), params),
                params,
            )
        )
        np.testing.assert_array_equal(direct, ref)
        # ...and the scan only reassociates f32 (noise frames are the
        # worst case for the damped 2x2 solve)
        np.testing.assert_allclose(flows[t], ref, atol=2e-3)


@requires_cv2
def test_farneback_packed_mode_within_budget(frame_pair_small):
    """warp_mode='packed' (bf16-pair gathers) must stay far inside the
    0.5 px budget vs cv2 — measured ~1e-3 px mean on the corpus."""
    a, b = frame_pair_small
    ref = cv2.calcOpticalFlowFarneback(a, b, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    ours = np.asarray(
        farneback(
            jnp.asarray(a, jnp.float32),
            jnp.asarray(b, jnp.float32),
            FarnebackParams(warp_mode="packed"),
        )
    )
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 0.02
    assert np.percentile(epe, 99) < 0.2


@requires_cv2
def test_farneback_gaussian_flag(frame_pair_small):
    """OPTFLOW_FARNEBACK_GAUSSIAN -> FarnebackParams.gaussian_win=True
    (OpenCV FarnebackUpdateFlow_GaussianBlur window weighting)."""
    a, b = frame_pair_small
    ref = cv2.calcOpticalFlowFarneback(
        a, b, None, 0.5, 2, 15, 2, 5, 1.2, cv2.OPTFLOW_FARNEBACK_GAUSSIAN
    )
    ours = np.asarray(
        farneback(
            jnp.asarray(a, jnp.float32),
            jnp.asarray(b, jnp.float32),
            FarnebackParams(levels=2, iterations=2, gaussian_win=True),
        )
    )
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 1e-2
    assert epe.max() < 0.5


@requires_cv2
def test_farneback_use_initial_flow(frame_pair_small):
    """OPTFLOW_USE_INITIAL_FLOW -> the flow0 argument (the caller's flow
    is INTER_AREA-resized to the top level and scaled as the seed)."""
    a, b = frame_pair_small
    seed = cv2.calcOpticalFlowFarneback(a, b, None, 0.5, 1, 9, 1, 5, 1.2, 0)
    ref = cv2.calcOpticalFlowFarneback(
        a, b, seed.copy(), 0.5, 2, 15, 2, 5, 1.2, cv2.OPTFLOW_USE_INITIAL_FLOW
    )
    ours = np.asarray(
        farneback(
            jnp.asarray(a, jnp.float32),
            jnp.asarray(b, jnp.float32),
            FarnebackParams(levels=2, iterations=2),
            flow0=jnp.asarray(seed),
        )
    )
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe.mean() < 1e-2
    assert epe.max() < 0.5
