"""Motion-only pose optimization (batched Levenberg-Marquardt on SE3).

Replaces reference Optimizer::PoseOptimization (src/Optimizer.cc:220-432):
one SE3 vertex, N monocular and stereo reprojection edges
(Edge{,Stereo}SE3ProjectXYZOnlyPose) with per-edge information invSigma2*I
and Huber kernels delta=sqrt(5.991) mono / sqrt(7.815) stereo, run as
4 rounds x 10 LM iterations with chi2-based inlier reclassification between
rounds (outliers excluded but may return); the Huber kernel is dropped after
round 2, matching the reference (:393).

Stereo edges carry a third residual component u_r - (u - bf/z) (the
right-view column of a rectified pair); features with obs_ur < 0 are mono.

Design: residuals/Jacobians for all N edges are one batched computation;
the normal equations are a 6x6 solve; rounds and LM iterations are
lax.fori_loop — the whole optimization is a single fused device program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


from orb_slam_system_tpu.utils import lie

CHI2_MONO = 5.991            # reference src/Optimizer.cc:330
CHI2_STEREO = 7.815          # reference chi2Stereo
HUBER_DELTA_MONO = 2.447731  # sqrt(5.991)
HUBER_DELTA_STEREO = 2.795532  # sqrt(7.815)


def _residuals_jac(xi, T0, Xw, obs, obs_ur, bf, fx, fy, cx, cy):
    """Residuals e = [obs_uv - pi(X); obs_ur - (u - bf/z)] and Jacobians.
    Returns e [N,3], J [N,3,6], z [N], is_stereo [N]."""
    T = lie.se3_exp(xi) @ T0
    R = T[:3, :3]
    t = T[:3, 3]
    Xc = Xw @ R.T + t
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / zs
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    is_stereo = obs_ur >= 0
    e = jnp.stack([
        obs[:, 0] - u,
        obs[:, 1] - v,
        jnp.where(is_stereo, obs_ur - ur, 0.0),
    ], axis=1)
    zero = jnp.zeros_like(x)
    # d(u,v,ur)/d(Xc): [N,3,3].
    J_proj = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], axis=1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], axis=1),
            jnp.stack([fx * inv_z, zero,
                       (-fx * x + bf) * inv_z * inv_z], axis=1),
        ],
        axis=1,
    )

    def neg_hat(p):
        px, py, pz = p[0], p[1], p[2]
        z0 = jnp.zeros_like(px)
        return jnp.stack([
            jnp.stack([z0, pz, -py]),
            jnp.stack([-pz, z0, px]),
            jnp.stack([py, -px, z0]),
        ])

    nh = jax.vmap(neg_hat)(Xc)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), nh.shape)
    J_xc = jnp.concatenate([eye, nh], axis=2)        # [N,3,6]
    J = -jnp.einsum("nij,njk->nik", J_proj, J_xc)    # [N,3,6]
    J = J * jnp.where(is_stereo[:, None, None],
                      1.0, jnp.asarray([1.0, 1.0, 0.0])[None, :, None])
    return e, J, z, is_stereo


def _chi2(e, inv_sigma2):
    return jnp.sum(e * e, axis=1) * inv_sigma2


import functools


@functools.partial(jax.jit,
                   static_argnames=("n_rounds", "n_iters", "axis_name"))
def pose_optimization(
    Tcw0, Xw, obs, inv_sigma2, valid, fx, fy, cx, cy,
    obs_ur=None, bf=0.0,
    n_rounds: int = 4, n_iters: int = 10,
    axis_name: str | None = None,
):
    """Returns (Tcw, inlier bool[N], n_inliers i32).

    valid marks real (non-padded) correspondences; obs_ur (f32[N], -1 mono)
    adds stereo right-column residuals. Points behind the camera are
    outliers automatically.

    axis_name: if set, the edge set is sharded over that mesh axis — the
    6x6 normal equations (J^T W J, J^T W e) and LM costs are psum'd over it
    so every shard performs the identical solve (one global pose, bit-exact
    across shards); the returned inlier mask / count stay shard-local."""
    f32 = jnp.float32
    Xw = Xw.astype(f32)
    obs = obs.astype(f32)
    Tcw0 = Tcw0.astype(f32)
    if obs_ur is None:
        obs_ur = jnp.full(Xw.shape[0], -1.0, f32)
    obs_ur = obs_ur.astype(f32)
    inlier0 = valid

    def round_body(r, carry):
        T0, inlier = carry
        use_huber = r < 2  # reference drops the kernel after round 2 (:393)

        def chi_and_rho(xi):
            e, _, z, is_st = _residuals_jac(
                xi, T0, Xw, obs, obs_ur, bf, fx, fy, cx, cy)
            chi2 = _chi2(e, inv_sigma2)
            delta = jnp.where(is_st, HUBER_DELTA_STEREO, HUBER_DELTA_MONO)
            rho = jnp.where(
                use_huber & (chi2 > delta * delta),
                2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - delta * delta,
                chi2,
            )
            return chi2, rho, z, is_st, delta

        def psum_(x):
            return jax.lax.psum(x, axis_name) if axis_name else x

        def lm_cost(xi, active):
            _, rho, z, _, _ = chi_and_rho(xi)
            return psum_(jnp.sum(jnp.where(active & (z > 0), rho, 0.0)))

        def lm_iter(i, state):
            xi, lam = state
            e, J, z, is_st = _residuals_jac(
                xi, T0, Xw, obs, obs_ur, bf, fx, fy, cx, cy)
            chi2 = _chi2(e, inv_sigma2)
            delta = jnp.where(is_st, HUBER_DELTA_STEREO, HUBER_DELTA_MONO)
            w_h = jnp.where(
                use_huber,
                jnp.minimum(1.0, delta / jnp.sqrt(jnp.maximum(chi2, 1e-12))),
                1.0)
            w = jnp.where(inlier & (z > 0), w_h * inv_sigma2, 0.0)
            H = psum_(jnp.einsum("n,nif,nig->fg", w, J, J))
            g = psum_(jnp.einsum("n,nif,ni->f", w, J, e))
            A = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6, dtype=f32)
            dx = jnp.linalg.solve(A, -g)
            cost0 = lm_cost(xi, inlier)
            cost1 = lm_cost(xi + dx, inlier)
            improved = cost1 < cost0
            xi_new = jnp.where(improved, xi + dx, xi)
            lam_new = jnp.clip(jnp.where(improved, lam * 0.5, lam * 4.0),
                               1e-10, 1e6)
            return xi_new, lam_new

        xi0 = jnp.zeros(6, f32)
        xi, _ = jax.lax.fori_loop(0, n_iters, lm_iter,
                                  (xi0, jnp.asarray(1e-4, f32)))
        T_new = lie.se3_exp(xi) @ T0
        # Reclassify: raw chi2 against the 95% gates (reference :348-423).
        e, _, z, is_st = _residuals_jac(
            jnp.zeros(6, f32), T_new, Xw, obs, obs_ur, bf, fx, fy, cx, cy)
        chi2 = _chi2(e, inv_sigma2)
        gate = jnp.where(is_st, CHI2_STEREO, CHI2_MONO)
        inlier_new = valid & (z > 0) & (chi2 <= gate)
        return T_new, inlier_new

    T, inlier = jax.lax.fori_loop(0, n_rounds, round_body, (Tcw0, inlier0))
    return T, inlier, jnp.sum(inlier.astype(jnp.int32))
