"""Ring-scheduled distributed bundle adjustment (SURVEY.md §5.7b: the
ring-attention *pattern* applied to BA factor blocks).

parallel/ba_dist.py shards the LANDMARK axis and psums the reduced
camera system — communication O(M^2) blocks, ideal when L >> M. This
module shards the KEYFRAME axis instead, for large windows:

- each device owns a camera shard's observation table (Mloc, L) and
  computes only its own residuals/Jacobians (the (M, L) work is what
  dominates BA; poses and landmarks themselves are tiny and stay
  replicated so the update/gauge logic is identical on every device);
- the landmark Hessians C (L,3,3) and gradients w (L,3) are psum-reduced
  once (they are sums over cameras);
- the cross-camera Schur blocks E_m C^-1 E_n^T couple camera shards, so
  each device whitens its factor G_m = E_m · chol(C^-1) and the shards
  ring-rotate with lax.ppermute: after n-1 rounds every device has
  accumulated its ROW BLOCK of the reduced system as local (Mloc x Mloc)
  outer products G_i G_j^T — per-round traffic is one G shard
  (Mloc·L·18 floats), overlapping compute with neighbor transfer on the
  device ring exactly like ring attention rotates KV blocks;
- row blocks are all_gathered (small: M^2 6x6) and the pinned (6M, 6M)
  system is solved replicated; landmark back-substitution psums the
  per-shard E^T dc terms.

Matches nav/ba.py bundle_adjust step-for-step (same damping, accept/
reject, gauge fixes); equality vs the single-device solver is asserted
on the 8-virtual-device CPU mesh in tests/test_pose_ba.py.

No analog in the reference (single-threaded, cv2-only — SURVEY.md §2.4);
this is a north-star extension (BASELINE.json config 5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..nav.ba import (
    BAState,
    BAStats,
    _residuals_and_jacobians,
    _schur_terms,
    rodrigues,
    so3_log,
)


def _local_cost(rvecs_l, tvecs_l, points, obs_l, mask_l, axis_name):
    st = BAState(rvecs=rvecs_l, tvecs=tvecs_l, points=points, obs=obs_l, mask=mask_l)
    r, _, _ = _residuals_and_jacobians(st)
    return lax.psum(jnp.sum(mask_l * jnp.sum(r * r, axis=-1)), axis_name)


def ring_bundle_adjust(
    state: BAState,
    mesh: Mesh,
    axis_name: str = "win",
    iters: int = 10,
    lam: float = 1e-4,
    fix_scale: bool = True,
) -> tuple[BAState, BAStats]:
    """Run windowed BA with the keyframe axis's WORK sharded over
    `axis_name` and Schur factors exchanged on a ppermute ring.

    The keyframe count must be divisible by the mesh axis size. Poses and
    landmarks are replicated parameters; obs/mask are sharded by camera.
    """
    n = mesh.shape[axis_name]
    m = state.rvecs.shape[0]
    if m % n:
        raise ValueError(f"keyframe count {m} not divisible by {n} devices")
    mloc = m // n
    fwd = [(i, (i + 1) % n) for i in range(n)]

    def local(rvecs, tvecs, points, obs_l, mask_l):
        idx = lax.axis_index(axis_name)

        def slice_cams(a):
            return lax.dynamic_slice_in_dim(a, idx * mloc, mloc, axis=0)

        def cost_of(rv, tv, pts):
            return _local_cost(
                slice_cams(rv), slice_cams(tv), pts, obs_l, mask_l, axis_name
            )

        init_cost = cost_of(rvecs, tvecs, points)
        t1_norm = jnp.linalg.norm(tvecs[1]) if m > 1 else 1.0

        def step(carry, _):
            rv, tv, pts, lam_c = carry
            st_l = BAState(
                rvecs=slice_cams(rv),
                tvecs=slice_cams(tv),
                points=pts,
                obs=obs_l,
                mask=mask_l,
            )
            r, Jc, Jp = _residuals_and_jacobians(st_l)
            B_l, C_p, E_l, v_l, wg_p = _schur_terms(r, Jc, Jp, mask_l)
            C = lax.psum(C_p, axis_name)
            wg = lax.psum(wg_p, axis_name)
            Cinv = jnp.linalg.inv(C + lam_c * jnp.eye(3)[None])
            # whitened factor: E Cinv E^T = (E Lc)(E Lc)^T, Lc = chol(Cinv)
            Lc = jnp.linalg.cholesky(Cinv)
            G_l = jnp.einsum("mlij,ljk->mlik", E_l, Lc)

            s_rows0 = jnp.zeros((mloc, m, 6, 6), G_l.dtype)

            def ring_body(k, carry):
                G_rot, s_rows = carry
                src = (idx - k) % n
                # -E_m Cinv E_n^T row block for this round's visitor
                blk = -jnp.einsum("mlij,nlkj->mnik", G_l, G_rot)
                s_rows = lax.dynamic_update_slice_in_dim(
                    s_rows, blk, src * mloc, axis=1
                )
                G_rot = lax.ppermute(G_rot, axis_name, fwd)
                return (G_rot, s_rows)

            _, s_rows = lax.fori_loop(0, n, ring_body, (G_l, s_rows0))
            # diagonal camera blocks + damping
            diag = B_l + lam_c * jnp.eye(6)[None]
            s_rows = s_rows.at[jnp.arange(mloc), idx * mloc + jnp.arange(mloc)].add(
                diag
            )
            rhs_l = v_l - jnp.einsum("mlij,ljk,lk->mi", E_l, Cinv, wg)

            S = lax.all_gather(s_rows, axis_name).reshape(m, m, 6, 6)
            rhs = lax.all_gather(rhs_l, axis_name).reshape(m, 6)

            S2 = jnp.transpose(S, (0, 2, 1, 3)).reshape(6 * m, 6 * m)
            rhs2 = rhs.reshape(6 * m)
            pin = jnp.arange(6)  # pose 0 gauge (as nav/ba.py)
            S2 = S2.at[pin, :].set(0.0).at[:, pin].set(0.0)
            S2 = S2.at[pin, pin].set(1.0)
            rhs2 = rhs2.at[pin].set(0.0)
            dc = jnp.linalg.solve(S2, rhs2).reshape(m, 6)

            dc_l = lax.dynamic_slice_in_dim(dc, idx * mloc, mloc, axis=0)
            et_dc = lax.psum(jnp.einsum("mlij,mi->lj", E_l, dc_l), axis_name)
            dp = jnp.einsum("lij,lj->li", Cinv, wg - et_dc)

            # replicated pose/landmark update — identical math to nav/ba.py
            dR = jax.vmap(rodrigues)(dc[:, :3])
            new_rv = jax.vmap(lambda dr, w: so3_log(dr @ rodrigues(w)))(dR, rv)
            new_tv = jnp.einsum("mij,mj->mi", dR, tv) + dc[:, 3:]
            new_pts = pts + dp
            if fix_scale and m > 1:
                scale = t1_norm / jnp.maximum(jnp.linalg.norm(new_tv[1]), 1e-12)
                new_tv = new_tv * scale
                new_pts = new_pts * scale
            c_old = cost_of(rv, tv, pts)
            c_new = cost_of(new_rv, new_tv, new_pts)
            improved = c_new < c_old
            rv, tv, pts = jax.tree.map(
                lambda a, b: jnp.where(improved, a, b),
                (new_rv, new_tv, new_pts),
                (rv, tv, pts),
            )
            lam_c = jnp.where(improved, lam_c * 0.7, lam_c * 4.0)
            return (rv, tv, pts, lam_c), c_new

        (rvecs, tvecs, points, _), _ = lax.scan(
            step, (rvecs, tvecs, points, jnp.float32(lam)), None, length=iters
        )
        final = cost_of(rvecs, tvecs, points)
        n_obs = lax.psum(jnp.sum(mask_l), axis_name)
        return rvecs, tvecs, points, final, init_cost, n_obs

    rep = P()
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(rep, rep, rep, P(axis_name, None, None), P(axis_name, None)),
        out_specs=(rep, rep, rep, rep, rep, rep),
        check_vma=False,
    )
    rvecs, tvecs, points, cost, init_cost, n_obs = fn(
        state.rvecs, state.tvecs, state.points, state.obs, state.mask
    )
    return (
        state._replace(rvecs=rvecs, tvecs=tvecs, points=points),
        BAStats(cost=cost, initial_cost=init_cost, n_obs=n_obs),
    )
