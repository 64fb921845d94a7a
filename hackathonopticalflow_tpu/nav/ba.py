"""Windowed bundle adjustment with Schur complement (north-star extension;
no analog in the reference — SURVEY.md §5.7b).

Problem: M keyframe poses (world->camera, so(3) rotation vector + t) and
L landmarks (world 3D), dense observation table z (M, L, 2) in normalized
camera coords with validity mask. Minimize the reprojection energy with
Levenberg-damped Gauss-Newton:

    r_{kl} = proj(R_k X_l + t_k) - z_{kl}

Structure exploited for the accelerator: everything is batched einsum algebra —
per-observation 2x6 / 2x3 Jacobians vmapped over (M, L); the landmark
blocks C_l (3x3, block diagonal) are inverted in a batch; the reduced
camera system

    (B - E C^-1 E^T + lambda I) delta_c = v - E C^-1 w

is a dense (6M, 6M) solve (M is a small window, e.g. 8-16 keyframes).
Gauge: pose 0 is frozen (its 6 dof rows/cols are pinned) and the monocular
scale is fixed by renormalizing ||t_1|| after each step.

The landmark axis L is embarrassingly parallel — parallel/ba_dist.py
shards it across devices and psums the reduced system (the ring/Schur
pattern of SURVEY.md §5.7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def rodrigues(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) vector -> rotation matrix (Rodrigues), safe at 0."""
    theta = jnp.sqrt(jnp.sum(w * w) + 1e-24)
    k = w / theta
    K = jnp.array(
        [
            [0.0, -k[2], k[1]],
            [k[2], 0.0, -k[0]],
            [-k[1], k[0], 0.0],
        ]
    )
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    R = jnp.eye(3) + s * K + (1.0 - c) * (K @ K)
    return jnp.where(theta < 1e-9, jnp.eye(3), R)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> so(3) vector (inverse Rodrigues), safe near 0."""
    c = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(c)
    axis_raw = jnp.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
    s = jnp.sin(theta)
    scale = jnp.where(jnp.abs(s) < 1e-7, 0.5, theta / (2.0 * jnp.maximum(s, 1e-12)))
    return axis_raw * scale


class BAState(NamedTuple):
    rvecs: jnp.ndarray  # (M, 3) world->cam rotation vectors
    tvecs: jnp.ndarray  # (M, 3)
    points: jnp.ndarray  # (L, 3) world landmarks
    obs: jnp.ndarray  # (M, L, 2) normalized observations
    mask: jnp.ndarray  # (M, L) bool validity


class BAStats(NamedTuple):
    cost: jnp.ndarray  # () final weighted SSE
    initial_cost: jnp.ndarray
    n_obs: jnp.ndarray


def _residuals_and_jacobians(state: BAState):
    """Batched residuals r (M,L,2), pose Jacobians Jc (M,L,2,6) and point
    Jacobians Jp (M,L,2,3)."""
    Rs = jax.vmap(rodrigues)(state.rvecs)  # (M,3,3)
    # camera-frame points: (M, L, 3)
    pc = jnp.einsum("mij,lj->mli", Rs, state.points) + state.tvecs[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = x / zs
    v = y / zs
    r = jnp.stack([u, v], axis=-1) - state.obs

    # d(u,v)/d(pc): (M,L,2,3)
    zi = 1.0 / zs
    zero = jnp.zeros_like(zi)
    dproj = jnp.stack(
        [
            jnp.stack([zi, zero, -u * zi], axis=-1),
            jnp.stack([zero, zi, -v * zi], axis=-1),
        ],
        axis=-2,
    )
    # d pc / d t = I ; d pc / d w ~ -[pc]_x (left perturbation R <- (I+[dw]_x)R)
    px, py, pz = pc[..., 0], pc[..., 1], pc[..., 2]
    zero = jnp.zeros_like(px)
    pc_hat = jnp.stack(
        [
            jnp.stack([zero, -pz, py], axis=-1),
            jnp.stack([pz, zero, -px], axis=-1),
            jnp.stack([-py, px, zero], axis=-1),
        ],
        axis=-2,
    )  # (M,L,3,3)
    d_dw = -pc_hat
    Jc = jnp.concatenate(
        [jnp.einsum("mlab,mlbc->mlac", dproj, d_dw), dproj], axis=-1
    )  # (M,L,2,6): [dw | dt]
    Jp = jnp.einsum("mlab,mbc->mlac", dproj, jax.vmap(rodrigues)(state.rvecs))
    return r, Jc, Jp


def _schur_terms(r, Jc, Jp, weights):
    """Per-landmark contributions to the reduced camera system.
    weights: (M, L) float — validity mask times any IRLS robust weight."""
    w = weights.astype(r.dtype)[..., None, None]
    Jc_w = Jc * w
    Jp_w = Jp * w
    # B: (M,6,6) block-diagonal camera Hessian (sum over landmarks)
    B = jnp.einsum("mlai,mlaj->mij", Jc_w, Jc)
    # C: (L,3,3) landmark Hessians (sum over cameras)
    C = jnp.einsum("mlai,mlaj->lij", Jp_w, Jp)
    # E: (M,L,6,3)
    E = jnp.einsum("mlai,mlaj->mlij", Jc_w, Jp)
    # gradients
    v = -jnp.einsum("mlai,mla->mi", Jc_w, r)
    wg = -jnp.einsum("mlai,mla->li", Jp_w, r)
    return B, C, E, v, wg


def _solve_reduced(B, C, E, v, wg, lam, fix_first: bool = True, preduce=lambda x: x):
    m = B.shape[0]
    C_damped = C + lam * jnp.eye(3)[None]
    Cinv = jnp.linalg.inv(C_damped)  # (L,3,3) batch
    # S = blockdiag(B) - E Cinv E^T aggregated into (6M, 6M)
    # landmark-sharded contributions are psum-reduced here (ba_dist.py);
    # single-device preduce is the identity
    ECET = preduce(jnp.einsum("mlij,ljk,nlpk->mnip", E, Cinv, E))  # (M,N,6,6)
    B = preduce(B)
    S = -ECET
    S = S.at[jnp.arange(m), jnp.arange(m)].add(B + lam * jnp.eye(6)[None])
    rhs = preduce(v - jnp.einsum("mlij,ljk,lk->mi", E, Cinv, wg))  # (M,6)

    S2 = jnp.transpose(S, (0, 2, 1, 3)).reshape(6 * m, 6 * m)
    rhs2 = rhs.reshape(6 * m)
    if fix_first:
        # pin pose 0: identity rows/cols, zero rhs
        pin = jnp.arange(6)
        S2 = S2.at[pin, :].set(0.0).at[:, pin].set(0.0)
        S2 = S2.at[pin, pin].set(1.0)
        rhs2 = rhs2.at[pin].set(0.0)
    dc = jnp.linalg.solve(S2, rhs2).reshape(m, 6)
    # back-substitute landmarks: dx = Cinv (w - E^T dc)
    dp = jnp.einsum("lij,lj->li", Cinv, wg - jnp.einsum("mlij,mi->lj", E, dc))
    return dc, dp


def _huber_weights(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weights for the Huber loss on the per-observation residual
    NORM: w = 1 inside delta, delta/||r|| outside. (M, L)."""
    rn = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-24)
    return jnp.minimum(1.0, delta / rn)


def _cost(state: BAState, preduce=lambda x: x, huber_delta=None) -> jnp.ndarray:
    r, _, _ = _residuals_and_jacobians(state)
    sq = jnp.sum(r * r, axis=-1)
    if huber_delta is None:
        return preduce(jnp.sum(state.mask * sq))
    # Huber rho on the residual norm: r^2 inside, 2*delta*||r|| - delta^2
    # outside (the factor-2 convention keeps rho == r^2 in the interior
    # so costs stay comparable with the SSE path)
    rn = jnp.sqrt(sq + 1e-24)
    rho = jnp.where(
        rn <= huber_delta, sq, 2.0 * huber_delta * rn - huber_delta**2
    )
    return preduce(jnp.sum(state.mask * rho))


def bundle_adjust(
    state: BAState,
    iters: int = 10,
    lam: float = 1e-4,
    fix_scale: bool = True,
    preduce=lambda x: x,
    huber_delta: float | None = None,
) -> tuple[BAState, BAStats]:
    """Levenberg-damped Gauss-Newton with Schur reduction; fixed iteration
    count (jit-friendly). Accepts a step only if it lowers the cost
    (simple trust behavior without dynamic lambda re-solves).

    huber_delta: residual-norm scale (normalized camera coords) of a
    Huber robust loss, applied by IRLS re-weighting of the normal
    equations; None keeps the plain SSE. A good default is the pixel
    gate used for RANSAC, e.g. 2 px / fx (nav/odometry.py)."""
    init_cost = _cost(state, preduce, huber_delta)
    t1_norm = jnp.linalg.norm(state.tvecs[1]) if state.tvecs.shape[0] > 1 else 1.0

    def step(carry, _):
        st, lam_c = carry
        r, Jc, Jp = _residuals_and_jacobians(st)
        wts = st.mask.astype(r.dtype)
        if huber_delta is not None:
            wts = wts * _huber_weights(r, huber_delta)
        B, C, E, v, wg = _schur_terms(r, Jc, Jp, wts)
        dc, dp = _solve_reduced(B, C, E, v, wg, lam_c, preduce=preduce)
        # left perturbation of the full transform pc' = exp(dw) pc + dt
        # (matches the -[pc]_x Jacobian): R <- exp(dw) R, t <- exp(dw) t + dt
        dR = jax.vmap(rodrigues)(dc[:, :3])
        new_rvecs = jax.vmap(lambda dr, rv: so3_log(dr @ rodrigues(rv)))(
            dR, st.rvecs
        )
        new_tvecs = jnp.einsum("mij,mj->mi", dR, st.tvecs) + dc[:, 3:]
        new_points = st.points + dp
        if fix_scale and st.tvecs.shape[0] > 1:
            scale = t1_norm / jnp.maximum(jnp.linalg.norm(new_tvecs[1]), 1e-12)
            new_tvecs = new_tvecs * scale
            new_points = new_points * scale
        cand = st._replace(rvecs=new_rvecs, tvecs=new_tvecs, points=new_points)
        c_old = _cost(st, preduce, huber_delta)
        c_new = _cost(cand, preduce, huber_delta)
        improved = c_new < c_old
        st = jax.tree.map(
            lambda a, b: jnp.where(improved, a, b),
            cand,
            st,
        )
        lam_c = jnp.where(improved, lam_c * 0.7, lam_c * 4.0)
        return (st, lam_c), c_new

    (state, _), _ = jax.lax.scan(step, (state, jnp.float32(lam)), None, length=iters)
    return state, BAStats(
        cost=_cost(state, preduce, huber_delta),
        initial_cost=init_cost,
        n_obs=preduce(jnp.sum(state.mask)),
    )
