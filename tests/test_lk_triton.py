"""The Triton LK level kernel (ops/lk_triton.py), run in the Pallas
interpreter on CPU, against the XLA level loop it replaces on CUDA
(ops/lk.py _level_lk_xla) — same points, same prepared frames."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import LKParams
from hackathonopticalflow_tpu.io.synthetic import seeded_clip, textured_frame
from hackathonopticalflow_tpu.ops.lk import (
    _frame_pad,
    _level_lk_xla,
    prepare_frame,
    pyr_lk,
)
from hackathonopticalflow_tpu.ops.lk_triton import level_lk_triton

H, W = 96, 128


@pytest.fixture(scope="module")
def clip():
    return seeded_clip(3, H, W, seed=5).astype(np.float32)


def _run_level(prev, nxt, pts, tl0, status, level, params, interpret_kernel):
    args = (
        prev.img_p[level], prev.dix_p[level], prev.diy_p[level],
        nxt.img_p[level], pts, tl0, status,
    )
    if interpret_kernel:
        return level_lk_triton(
            *args, level=level, win_size=params.win_size,
            pad=_frame_pad(params), max_iters=params.max_iters, eps=params.eps,
            min_eig_threshold=params.min_eig_threshold,
            compute_err=params.compute_err, interpret=True,
        )
    return _level_lk_xla(*args, level=level, params=params)


def _compare(ref, got, atol=1e-3):
    tl_r, st_r, err_r = map(np.asarray, ref)
    tl_g, st_g, err_g = map(np.asarray, got)
    np.testing.assert_array_equal(st_g, st_r)
    live = st_r
    assert np.abs(tl_g - tl_r)[live].max(initial=0.0) <= atol
    np.testing.assert_allclose(err_g[live], err_r[live], atol=1e-3)


def _points(n, seed, margin=4.0):
    rng = np.random.RandomState(seed)
    return jnp.asarray(
        np.stack(
            [rng.uniform(margin, W - margin, n), rng.uniform(margin, H - margin, n)],
            -1,
        ).astype(np.float32)
    )


def _level_inputs(clip, params, n, level, seed=0, init_offset=(1.5, -0.75)):
    prev = prepare_frame(jnp.asarray(clip[0]), params)
    nxt = prepare_frame(jnp.asarray(clip[1]), params)
    pts = _points(n, seed)
    win_w, win_h = params.win_size
    half = jnp.array([(win_w - 1) * 0.5, (win_h - 1) * 0.5], jnp.float32)
    tl0 = pts * (1.0 / (1 << level)) - half + jnp.asarray(init_offset)
    status = jnp.ones(n, bool)
    return prev, nxt, pts, tl0, status


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("win", [45, 15])
def test_kernel_matches_xla_level(clip, win, level):
    params = LKParams(win_size=(win, win))
    inputs = _level_inputs(clip, params, 24, level, seed=level)
    ref = _run_level(*inputs, level, params, interpret_kernel=False)
    got = _run_level(*inputs, level, params, interpret_kernel=True)
    _compare(ref, got)


@pytest.mark.parametrize("n", [1, 37, 130])
def test_kernel_point_counts(clip, n):
    """Any point count: one program per point, no block padding."""
    params = LKParams(win_size=(15, 15))
    inputs = _level_inputs(clip, params, n, 0, seed=n)
    ref = _run_level(*inputs, 0, params, interpret_kernel=False)
    got = _run_level(*inputs, 0, params, interpret_kernel=True)
    assert np.asarray(got[0]).shape == (n, 2)
    _compare(ref, got)


def test_kernel_oob_points(clip):
    """Templates outside the frame and inits far outside it lose their
    status at level 0 exactly as in the XLA loop; their positions pass
    through unchanged."""
    params = LKParams(win_size=(15, 15))
    prev, nxt, pts, tl0, status = _level_inputs(clip, params, 8, 0)
    pts = pts.at[0].set(jnp.array([-40.0, 10.0])).at[1].set(jnp.array([10.0, H + 30.0]))
    tl0 = tl0.at[2].set(jnp.array([W + 500.0, 3.0])).at[3].set(jnp.array([-1e4, -1e4]))
    ref = _run_level(prev, nxt, pts, tl0, status, 0, params, False)
    got = _run_level(prev, nxt, pts, tl0, status, 0, params, True)
    _compare(ref, got)
    st = np.asarray(got[1])
    assert not st[:4].any()
    np.testing.assert_array_equal(np.asarray(got[0])[2:4], np.asarray(tl0)[2:4])


def test_kernel_degenerate_templates():
    """A flat template has a singular structure tensor: status drops at
    level 0 and the point does not move."""
    params = LKParams(win_size=(15, 15))
    img = textured_frame(H, W, seed=3)
    img[:, : W // 2] = 90.0
    prev = prepare_frame(jnp.asarray(img), params)
    nxt = prepare_frame(jnp.asarray(np.roll(img, 2, axis=1)), params)
    pts = jnp.asarray([[20.0, 40.0], [30.0, 60.0], [100.0, 50.0]], jnp.float32)
    tl0 = pts - 7.0
    status = jnp.ones(3, bool)
    ref = _run_level(prev, nxt, pts, tl0, status, 0, params, False)
    got = _run_level(prev, nxt, pts, tl0, status, 0, params, True)
    _compare(ref, got)
    assert list(np.asarray(got[1])) == [False, False, True]
    np.testing.assert_array_equal(np.asarray(got[0])[:2], np.asarray(tl0)[:2])


@pytest.mark.parametrize("win", [45, 15])
def test_kernel_pyramid_large_flow(win):
    """All three levels chained on a 12 px shift at 128 px width (a 45 px
    flow at 1080p scale): the kernel's coarse-to-fine result equals the
    XLA loop's and recovers the shift."""
    params = LKParams(win_size=(win, win))
    base = textured_frame(H, W + 16, seed=9)
    a = jnp.asarray(base[:, :W])
    b = jnp.asarray(base[:, 12 : W + 12])  # content moves 12 px left
    prev, nxt = prepare_frame(a, params), prepare_frame(b, params)
    pts = _points(20, 4, margin=20.0)
    half = jnp.array([(win - 1) * 0.5] * 2, jnp.float32)
    out = {}
    for use_kernel in (False, True):
        center = pts * 0.25
        status = jnp.ones(pts.shape[0], bool)
        for level in (2, 1, 0):
            if level != 2:
                center = center * 2.0
            tl, status, err = _run_level(
                prev, nxt, pts, center - half, status, level, params, use_kernel
            )
            center = tl + half
        out[use_kernel] = (center, status, err)
    ref, got = out[False], out[True]
    _compare((ref[0] - half, ref[1], ref[2]), (got[0] - half, got[1], got[2]))
    st = np.asarray(got[1])
    flow = np.asarray(got[0] - pts)[st]
    assert st.mean() > 0.8
    assert np.median(np.abs(flow[:, 0] + 12.0)) < 0.05


def test_kernel_compute_err_off(clip):
    params = LKParams(win_size=(15, 15), compute_err=False)
    inputs = _level_inputs(clip, params, 16, 0)
    ref = _run_level(*inputs, 0, params, False)
    got = _run_level(*inputs, 0, params, True)
    _compare(ref, got)
    assert not np.asarray(got[2]).any()


def test_kernel_under_vmap(clip):
    """Streams are vmapped over LK (parallel/streams.py): the batched
    kernel equals per-stream calls."""
    params = LKParams(win_size=(15, 15))
    prev, nxt, pts, tl0, status = _level_inputs(clip, params, 12, 0)
    nxt2 = prepare_frame(jnp.asarray(clip[2]), params)
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), nxt, nxt2)

    def one(n):
        return _run_level(prev, n, pts, tl0, status, 0, params, True)

    batched = jax.vmap(one)(stacked)
    for i, n in enumerate((nxt, nxt2)):
        single = one(n)
        for got, want in zip(batched, single):
            np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want))


def test_pyr_lk_cpu_runs_xla_level(clip):
    """On CPU the platform switch takes the XLA branch: pyr_lk equals the
    XLA level loop chained by hand."""
    params = LKParams(win_size=(15, 15))
    prev = prepare_frame(jnp.asarray(clip[0]), params)
    nxt = prepare_frame(jnp.asarray(clip[1]), params)
    pts = _points(10, 1, margin=10.0)
    res = pyr_lk(jnp.asarray(clip[0]), jnp.asarray(clip[1]), pts, params)
    half = jnp.array([7.0, 7.0], jnp.float32)
    center = pts * 0.25
    status = jnp.ones(10, bool)
    for level in (2, 1, 0):
        if level != 2:
            center = center * 2.0
        tl, status, err = _level_lk_xla(
            prev.img_p[level], prev.dix_p[level], prev.diy_p[level],
            nxt.img_p[level], pts, center - half, status,
            level=level, params=params,
        )
        center = tl + half
    np.testing.assert_array_equal(np.asarray(res.next_pts), np.asarray(center))
    np.testing.assert_array_equal(np.asarray(res.status), np.asarray(status))


def test_slab_path_skips_kernel():
    """slab_margin selects the XLA slab sampler on every backend: the
    level dispatch never builds the kernel for it."""
    import hackathonopticalflow_tpu.ops.lk as lk

    calls = []
    params = dataclasses.replace(LKParams(win_size=(15, 15)), slab_margin=4)
    img = jnp.asarray(textured_frame(H, W, seed=2))
    orig = lk.level_lk_triton
    try:
        lk.level_lk_triton = lambda *a, **k: calls.append(1) or orig(*a, **k)
        lk.pyr_lk(img, img, _points(4, 0, margin=10.0), params)
    finally:
        lk.level_lk_triton = orig
    assert not calls
