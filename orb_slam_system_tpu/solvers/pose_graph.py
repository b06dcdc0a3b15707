"""Sim3 pose-graph (essential graph) optimization + loop Sim3 refinement.

Replaces reference Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:
762-1025: Sim3 vertices over all keyframes; loop / spanning-tree /
covisibility(>=100 shared obs) edges; 20 LM iterations) and
Optimizer::OptimizeSim3 (:1027-1222: single Sim3 vertex with paired
forward/inverse projection edges, two-stage inlier filtering).

Design: padded vertex/edge arrays; per-edge residuals and exact
Jacobians batched via vmap(jacfwd); the sparse normal equations are solved
by preconditioned conjugate gradients whose matvec is two scatter-adds over
the edge list (block-Jacobi preconditioner from the accumulated 7x7
diagonal blocks) — no sparse-matrix library, and the same program shards
over a device mesh by partitioning edges.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


from orb_slam_system_tpu.utils import lie


def _sim3_from_arrays(R, t, s):
    return {"R": R, "t": t, "s": s}


def _edge_residual(xi_i, xi_j, S0_i, S0_j, Sji):
    """e = log( Sji * (exp(xi_i) S0_i) * (exp(xi_j) S0_j)^-1 )  [7]."""
    Si = lie.sim3_mul(lie.sim3_exp(xi_i), S0_i)
    Sj = lie.sim3_mul(lie.sim3_exp(xi_j), S0_j)
    E = lie.sim3_mul(Sji, lie.sim3_mul(Si, lie.sim3_inv(Sj)))
    return lie.sim3_log(E)


@functools.partial(jax.jit,
                   static_argnames=("n_iters", "cg_iters", "axis_name"))
def optimize_essential_graph(
    R0, t0, s0,            # f32[K,3,3], f32[K,3], f32[K] initial Sim3 (world->cam)
    v_fixed, v_valid,      # bool[K]
    e_i, e_j,              # i32[E] vertex indices
    e_R, e_t, e_s,         # measurement Sji per edge
    e_valid,               # bool[E]
    n_iters: int = 20,
    cg_iters: int = 50,
    axis_name=None,
):
    """Returns optimized (R f32[K,3,3], t f32[K,3], s f32[K]).

    With axis_name set (inside shard_map over an edge-sharded mesh
    axis), every global reduction — gradient, block-Jacobi diagonal, CG
    matvec, LM costs — is a psum over that axis, so each device performs
    the IDENTICAL global solve on its edge shard (the same pattern as
    local_ba.bundle_adjust_cg; parallel/pose_graph_dist.py is the thin
    shard_map wrapper)."""
    K = R0.shape[0]
    E = e_i.shape[0]
    f32 = t0.dtype
    free = v_valid & ~v_fixed
    psum_ = ((lambda x: x) if axis_name is None
             else (lambda x: jax.lax.psum(x, axis_name)))

    def residuals(xi):
        def per_edge(ii, jj, Re, te, se):
            S0_i = _sim3_from_arrays(R0[ii], t0[ii], s0[ii])
            S0_j = _sim3_from_arrays(R0[jj], t0[jj], s0[jj])
            Sji = _sim3_from_arrays(Re, te, se)
            return _edge_residual(xi[ii], xi[jj], S0_i, S0_j, Sji)
        return jax.vmap(per_edge)(e_i, e_j, e_R, e_t, e_s)

    def edge_jacobians(xi):
        def per_edge(ii, jj, Re, te, se):
            S0_i = _sim3_from_arrays(R0[ii], t0[ii], s0[ii])
            S0_j = _sim3_from_arrays(R0[jj], t0[jj], s0[jj])
            Sji = _sim3_from_arrays(Re, te, se)
            f = lambda a, b: _edge_residual(a, b, S0_i, S0_j, Sji)
            Ji = jax.jacfwd(f, argnums=0)(xi[ii], xi[jj])
            Jj = jax.jacfwd(f, argnums=1)(xi[ii], xi[jj])
            return Ji, Jj
        return jax.vmap(per_edge)(e_i, e_j, e_R, e_t, e_s)

    ew = e_valid.astype(f32)

    def gn_step(xi, lam):
        r = residuals(xi) * ew[:, None]                      # [E,7]
        Ji, Jj = edge_jacobians(xi)                          # [E,7,7] each
        Ji = Ji * ew[:, None, None]
        Jj = Jj * ew[:, None, None]
        b = -(jnp.zeros((K, 7), f32)
              .at[e_i].add(jnp.einsum("eab,ea->eb", Ji, r))
              .at[e_j].add(jnp.einsum("eab,ea->eb", Jj, r)))
        b = psum_(b) * free[:, None]
        # Block-Jacobi diagonal.
        Hd = (jnp.zeros((K, 7, 7), f32)
              .at[e_i].add(jnp.einsum("eab,eac->ebc", Ji, Ji))
              .at[e_j].add(jnp.einsum("eab,eac->ebc", Jj, Jj)))
        Hd = psum_(Hd) + (lam + 1e-6) * jnp.eye(7, dtype=f32)[None]
        Minv = jnp.linalg.inv(Hd)

        def matvec(x):
            x = x * free[:, None]
            u = (jnp.einsum("eab,eb->ea", Ji, x[e_i])
                 + jnp.einsum("eab,eb->ea", Jj, x[e_j]))
            y = (jnp.zeros((K, 7), f32)
                 .at[e_i].add(jnp.einsum("eab,ea->eb", Ji, u))
                 .at[e_j].add(jnp.einsum("eab,ea->eb", Jj, u)))
            y = psum_(y) + (lam + 1e-6) * x
            return y * free[:, None]

        def precond(x):
            return jnp.einsum("kab,kb->ka", Minv, x) * free[:, None]

        # PCG.
        x = jnp.zeros((K, 7), f32)
        r_cg = b
        z = precond(r_cg)
        p = z
        rz = jnp.sum(r_cg * z)

        def cg_body(_, st):
            x, r_cg, p, rz = st
            Ap = matvec(p)
            denom = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
            x = x + alpha * p
            r_new = r_cg - alpha * Ap
            z_new = precond(r_new)
            rz_new = jnp.sum(r_new * z_new)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1e-12, rz)
            p = z_new + beta * p
            return x, r_new, p, rz_new

        x, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body, (x, r_cg, p, rz))
        return x, psum_(jnp.sum(r * r))

    def lm_iter(_, carry):
        xi, lam = carry
        dx, cost0 = gn_step(xi, lam)
        xi_new = xi + dx
        cost1 = psum_(jnp.sum((residuals(xi_new) * ew[:, None]) ** 2))
        improved = cost1 < cost0
        xi = jnp.where(improved, xi_new, xi)
        lam = jnp.clip(jnp.where(improved, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        return xi, lam

    # Reference uses lambdaInit=1e-16 (:781) — effectively pure GN.
    xi, _ = jax.lax.fori_loop(0, n_iters, lm_iter,
                              (jnp.zeros((K, 7), f32), jnp.asarray(1e-10, f32)))

    def apply(ii):
        S = lie.sim3_mul(lie.sim3_exp(xi[ii]),
                         _sim3_from_arrays(R0[ii], t0[ii], s0[ii]))
        return S["R"], S["t"], S["s"]

    Rn, tn, sn = jax.vmap(apply)(jnp.arange(K))
    Rn = jnp.where(free[:, None, None], Rn, R0)
    tn = jnp.where(free[:, None], tn, t0)
    sn = jnp.where(free, sn, s0)
    return Rn, tn, sn


# ---------------------------------------------------------------------------
# OptimizeSim3: refine a single loop Sim3 with paired projection edges
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_iters",))
def optimize_sim3(
    s0, R0, t0,            # initial S12 (maps KF2 camera frame -> KF1)
    P1, P2,                # f32[N,3] camera-frame points in KF1 / KF2
    uv1, uv2,              # f32[N,2] observed pixels in KF1 / KF2
    inv_sigma2_1, inv_sigma2_2,
    valid, fx, fy, cx, cy,
    fix_scale: jnp.ndarray = False,
    th2: jnp.ndarray = 10.0,
    n_iters: int = 10,
):
    """Reference Optimizer::OptimizeSim3 (:1027-1222): minimize forward
    (P2 -> image 1) and inverse (P1 -> image 2) reprojection over the Sim3,
    Huber sqrt(10), drop chi2>10 outliers after a first pass, re-optimize.
    Returns (n_inliers, s, R, t, inlier_mask)."""
    f32 = P1.dtype
    delta = jnp.sqrt(th2)

    def residuals(xi, S_base):
        S = lie.sim3_mul(lie.sim3_exp(xi), S_base)
        Sinv = lie.sim3_inv(S)
        P2in1 = lie.sim3_apply(S, P2)
        P1in2 = lie.sim3_apply(Sinv, P1)

        def proj(P):
            z = jnp.where(jnp.abs(P[:, 2]) < 1e-9, 1e-9, P[:, 2])
            return jnp.stack([fx * P[:, 0] / z + cx,
                              fy * P[:, 1] / z + cy], axis=1)

        e1 = (uv1 - proj(P2in1))
        e2 = (uv2 - proj(P1in2))
        return e1, e2

    def chi2s(xi, S_base):
        e1, e2 = residuals(xi, S_base)
        return (jnp.sum(e1 * e1, axis=1) * inv_sigma2_1,
                jnp.sum(e2 * e2, axis=1) * inv_sigma2_2)

    S_base = {"R": R0, "t": t0, "s": s0}

    def run(active, S_base, iters):
        aw = active.astype(f32)

        def robust_cost(xi):
            c1, c2 = chi2s(xi, S_base)

            def huber(c):
                return jnp.where(c > th2, 2.0 * delta * jnp.sqrt(
                    jnp.maximum(c, 1e-12)) - th2, c)

            return jnp.sum((huber(c1) + huber(c2)) * aw)

        def res_vec(xi):
            e1, e2 = residuals(xi, S_base)
            r1 = e1 * jnp.sqrt(inv_sigma2_1)[:, None]
            r2 = e2 * jnp.sqrt(inv_sigma2_2)[:, None]
            return jnp.concatenate([r1, r2], axis=0)   # [2N,2]

        def lm(_, carry):
            xi, lam = carry
            # IRLS Huber weights from current chi2 (no grad through them).
            c1, c2 = chi2s(xi, S_base)
            w_h1 = jnp.minimum(1.0, delta / jnp.sqrt(jnp.maximum(c1, 1e-12)))
            w_h2 = jnp.minimum(1.0, delta / jnp.sqrt(jnp.maximum(c2, 1e-12)))
            w_all = jnp.concatenate([w_h1 * aw, w_h2 * aw])   # [2N]
            r = res_vec(xi)                                    # [2N,2]
            J = jax.jacfwd(res_vec)(xi)                        # [2N,2,7]
            H = jnp.einsum("n,nif,nig->fg", w_all, J, J)
            g = jnp.einsum("n,nif,ni->f", w_all, J, r)
            A = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7, dtype=f32)
            dx = -jnp.linalg.solve(A, g)
            dx = jnp.where(fix_scale, dx.at[6].set(0.0), dx)
            c0 = robust_cost(xi)
            c1_ = robust_cost(xi + dx)
            improved = c1_ < c0
            xi = jnp.where(improved, xi + dx, xi)
            lam = jnp.clip(jnp.where(improved, lam * 0.5, lam * 4.0),
                           1e-10, 1e8)
            return xi, lam

        xi, _ = jax.lax.fori_loop(0, iters, lm,
                                  (jnp.zeros(7, f32), jnp.asarray(1e-3, f32)))
        return xi

    xi = run(valid, S_base, n_iters)
    c1, c2 = chi2s(xi, S_base)
    inlier = valid & (c1 <= th2) & (c2 <= th2)
    # Stage 2 CONTINUES from the stage-1 optimum (upstream keeps the
    # vertex estimate and re-optimizes after removing outlier edges,
    # Optimizer.cc:1189-1209): rebase S at the stage-1 solution so the
    # second LM refines instead of re-deriving from the coarse RANSAC
    # seed. The final inlier mask covers only edges that SURVIVED stage
    # 1 — re-admitting a stage-1 outlier whose chi2 happens to pass at
    # the refined solution would hand loop closing a correspondence the
    # optimization never fit.
    S_base2 = lie.sim3_mul(lie.sim3_exp(xi), S_base)
    xi2 = run(inlier, S_base2, n_iters)
    c1, c2 = chi2s(xi2, S_base2)
    inlier = inlier & (c1 <= th2) & (c2 <= th2)
    S = lie.sim3_mul(lie.sim3_exp(xi2), S_base2)
    n_in = jnp.sum(inlier.astype(jnp.int32))
    return n_in, S["s"], S["R"], S["t"], inlier
