"""Windowed / global bundle adjustment: batched LM with Schur complement.

Replaces reference Optimizer::BundleAdjustment (src/Optimizer.cc:30-218) and
Optimizer::LocalBundleAdjustment (:434-759), which build g2o graphs with SE3
camera vertices, marginalized XYZ landmark vertices, Huber(sqrt(5.991)) mono
reprojection edges, and per-edge information invSigma2*I.

Design (SURVEY.md §7.1):
  * Fixed-shape problem: C padded cameras, P padded points, E padded edges
    (COO triplets cam_idx/pt_idx/uv), with validity masks — one compiled
    program per size class.
  * Per-iteration: all residuals/Jacobians batched over edges; camera and
    landmark Hessian blocks accumulated by scatter-add; landmark blocks
    (3x3) inverted in closed form; the reduced camera system (Schur
    complement) is assembled with dense einsums over a [C,P,6,3] cross-term
    tensor (local windows keep C small, so a dense solve is cheap) and
    solved as a (6C,6C) dense system.
  * Fixed cameras (the covisibility-boundary keyframes of the reference's
    local BA, :436-527) are handled by zeroing their rows/columns.
  * The LM loop is lax.while/fori with accept/reject damping; the
    reference's two-stage schedule (5 iters, drop chi2>5.991 outlier edges,
    10 more iters, :692-738) maps to two calls with an outlier mask computed
    between them (`classify_outliers`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


from orb_slam_system_tpu.utils import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_DELTA = 2.447731         # sqrt(5.991)
HUBER_DELTA_STEREO = 2.795532  # sqrt(7.815)


class BAProblem(NamedTuple):
    Tcw: jnp.ndarray          # f32[C,4,4]
    cam_fixed: jnp.ndarray    # bool[C]
    cam_valid: jnp.ndarray    # bool[C]
    points: jnp.ndarray       # f32[P,3]
    pt_valid: jnp.ndarray     # bool[P]
    e_cam: jnp.ndarray        # i32[E]
    e_pt: jnp.ndarray         # i32[E]
    e_uv: jnp.ndarray         # f32[E,2]
    e_inv_sigma2: jnp.ndarray # f32[E]
    e_valid: jnp.ndarray      # bool[E]
    e_ur: Optional[jnp.ndarray] = None  # f32[E] right-view u (-1 = mono)
    bf: float = 0.0           # stereo baseline * fx

    def ur(self):
        return (self.e_ur if self.e_ur is not None
                else jnp.full(self.e_cam.shape[0], -1.0, jnp.float32))


def _seg_sum(idx, blocks, n):
    """Segment sum by scatter-add: blocks[e] summed into out[idx[e]],
    [E,...] -> [n,...]. `idx` may be a tuple of index arrays with `n` the
    tuple of their extents (a block index). On the GPU the adds are
    atomics, so the f32 summation order varies from run to run."""
    lead = n if isinstance(n, tuple) else (n,)
    return jnp.zeros(lead + blocks.shape[1:], blocks.dtype).at[idx].add(blocks)


def _edge_residuals(xi_all, dX, prob: BAProblem, fx, fy, cx, cy):
    """Residuals and Jacobians for all edges at perturbed state.
    xi_all: f32[C,6] se3 updates (left-mult); dX: f32[P,3] point updates."""
    T = jax.vmap(lie.se3_exp)(xi_all) @ prob.Tcw     # [C,4,4]
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    X = prob.points + dX
    Xe = X[prob.e_pt]                                # [E,3]
    Re = R[prob.e_cam]                               # [E,3,3]
    te = t[prob.e_cam]
    Xc = jnp.einsum("eij,ej->ei", Re, Xe) + te
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / zs
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    e_ur = prob.ur()
    is_stereo = e_ur >= 0
    ur = u - prob.bf * inv_z
    e = jnp.stack([
        prob.e_uv[:, 0] - u,
        prob.e_uv[:, 1] - v,
        jnp.where(is_stereo, e_ur - ur, 0.0),
    ], axis=1)                                       # [E,3]
    zero = jnp.zeros_like(x)
    J_proj = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], axis=1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], axis=1),
            jnp.stack([fx * inv_z, zero,
                       (-fx * x + prob.bf) * inv_z * inv_z], axis=1),
        ],
        axis=1,
    )                                               # [E,3,3]
    row_mask = jnp.where(is_stereo[:, None],
                         jnp.ones(3, Xc.dtype)[None, :],
                         jnp.asarray([1.0, 1.0, 0.0], Xc.dtype)[None, :])
    J_proj = J_proj * row_mask[:, :, None]

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
    J_xc_cam = jnp.concatenate([eye, nh], axis=2)    # [E,3,6]
    Jc = -jnp.einsum("eij,ejk->eik", J_proj, J_xc_cam)   # [E,3,6]
    Jp = -jnp.einsum("eij,ejk->eik", J_proj, Re)         # [E,3,3]
    return e, Jc, Jp, z, is_stereo


def _robust_cost(e, inv_sigma2, active, use_huber, is_stereo):
    chi2 = jnp.sum(e * e, axis=1) * inv_sigma2
    delta = jnp.where(is_stereo, HUBER_DELTA_STEREO, HUBER_DELTA)
    rho = jnp.where(
        use_huber & (chi2 > delta * delta),
        2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - delta * delta,
        chi2,
    )
    return jnp.sum(jnp.where(active, rho, 0.0)), chi2


def _inv3x3(M):
    """Closed-form batched 3x3 inverse with damping-safe determinant."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    inv = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


@functools.partial(jax.jit, static_argnames=("n_iters", "use_huber"))
def bundle_adjust(prob: BAProblem, fx, fy, cx, cy,
                  n_iters: int = 10, use_huber: bool = True):
    """Runs n_iters LM iterations; returns (Tcw_new, points_new)."""
    C = prob.Tcw.shape[0]
    P = prob.points.shape[0]
    f32 = prob.points.dtype
    free_cam = (~prob.cam_fixed) & prob.cam_valid

    def cost_at(Tcw, X, xi_all, dX):
        p = prob._replace(Tcw=Tcw, points=X)
        e, _, _, z, is_st = _edge_residuals(xi_all, dX, p, fx, fy, cx, cy)
        cost, _ = _robust_cost(
            e, prob.e_inv_sigma2, prob.e_valid & (z > 0), use_huber, is_st)
        return cost

    def lm_iter(it, state):
        Tcw, X, lam = state
        p = prob._replace(Tcw=Tcw, points=X)
        zero_xi = jnp.zeros((C, 6), f32)
        zero_dx = jnp.zeros((P, 3), f32)
        e, Jc, Jp, z, is_st = _edge_residuals(zero_xi, zero_dx, p, fx, fy, cx, cy)
        chi2 = jnp.sum(e * e, axis=1) * prob.e_inv_sigma2
        delta_e = jnp.where(is_st, HUBER_DELTA_STEREO, HUBER_DELTA)
        w_h = jnp.where(
            jnp.asarray(use_huber),
            jnp.minimum(1.0, delta_e / jnp.sqrt(jnp.maximum(chi2, 1e-12))),
            1.0,
        )
        active = prob.e_valid & (z > 0)
        w = jnp.where(active, w_h * prob.e_inv_sigma2, 0.0)
        # Per-edge weighted blocks.
        Hcc_e = jnp.einsum("e,eif,eig->efg", w, Jc, Jc)      # [E,6,6]
        Hpp_e = jnp.einsum("e,eif,eig->efg", w, Jp, Jp)      # [E,3,3]
        Wcp_e = jnp.einsum("e,eif,eig->efg", w, Jc, Jp)      # [E,6,3]
        gc_e = jnp.einsum("e,eif,ei->ef", w, Jc, e)          # [E,6]
        gp_e = jnp.einsum("e,eif,ei->ef", w, Jp, e)          # [E,3]
        Hcc = _seg_sum(prob.e_cam, Hcc_e, C)
        Hpp = _seg_sum(prob.e_pt, Hpp_e, P)
        gc = _seg_sum(prob.e_cam, gc_e, C)
        gp = _seg_sum(prob.e_pt, gp_e, P)
        # Cross term A_cp[c,p] = sum_{e: cam=c, pt=p} Wcp_e[e].
        A_cp = _seg_sum((prob.e_cam, prob.e_pt), Wcp_e, (C, P))
        # LM damping (multiplicative on block diagonals).
        # eye * diag[:, :, None] is already the diagonal damping matrix.
        Hcc_d = Hcc + lam * jnp.eye(6, dtype=f32)[None] * jnp.maximum(
            jnp.diagonal(Hcc, axis1=1, axis2=2), 1e-6)[:, :, None]
        Hpp_d = Hpp + lam * jnp.eye(3, dtype=f32)[None] * jnp.maximum(
            jnp.diagonal(Hpp, axis1=1, axis2=2), 1e-6)[:, :, None]
        Hpp_inv = _inv3x3(Hpp_d)
        # Guard padded/unobserved points.
        pt_ok = prob.pt_valid & (jnp.einsum("pii->p", Hpp) > 1e-9)
        Hpp_inv = jnp.where(pt_ok[:, None, None], Hpp_inv, 0.0)
        # Schur complement S = Hcc - A Hpp^-1 A^T  (block [C,6,C,6]).
        AH = jnp.einsum("cpij,pjk->cpik", A_cp, Hpp_inv)     # [C,P,6,3]
        S_cross = jnp.einsum("cpik,dplk->cidl", AH, A_cp)    # [C,6,C,6]
        S = -S_cross
        idxC = jnp.arange(C)
        S = S.at[idxC, :, idxC, :].add(Hcc_d)
        rhs = -gc + jnp.einsum("cpik,pk->ci", AH, gp)        # [C,6]
        # Fix cameras: zero rows/cols, identity diagonal.
        fm = free_cam.astype(f32)
        S = S * fm[:, None, None, None] * fm[None, None, :, None]
        S = S.at[idxC, :, idxC, :].add(
            (1.0 - fm)[:, None, None] * jnp.eye(6, dtype=f32)[None])
        rhs = rhs * fm[:, None]
        dc = jnp.linalg.solve(S.reshape(C * 6, C * 6), rhs.reshape(C * 6))
        dc = dc.reshape(C, 6)
        # Back-substitute landmarks: dp = Hpp^-1 (-gp - A^T dc).
        Atdc = jnp.einsum("cpij,ci->pj", A_cp, dc)           # [P,3]
        dp = jnp.einsum("pjk,pk->pj", Hpp_inv, -gp - Atdc)
        dp = jnp.where(pt_ok[:, None], dp, 0.0)
        # Accept / reject.
        cost0 = cost_at(Tcw, X, zero_xi, zero_dx)
        cost1 = cost_at(Tcw, X, dc, dp)
        improved = cost1 < cost0
        Tcw_new = jnp.where(improved, jax.vmap(lie.se3_exp)(dc) @ Tcw, Tcw)
        X_new = jnp.where(improved, X + dp, X)
        lam_new = jnp.clip(jnp.where(improved, lam * 0.5, lam * 4.0), 1e-10, 1e8)
        return Tcw_new, X_new, lam_new

    Tcw, X, _ = jax.lax.fori_loop(
        0, n_iters, lm_iter,
        (prob.Tcw.astype(f32), prob.points.astype(f32), jnp.asarray(1e-4, f32)),
    )
    return Tcw, X


@functools.partial(jax.jit, static_argnames=("n_iters", "use_huber",
                                              "cg_iters", "axis_name"))
def bundle_adjust_cg(prob: BAProblem, fx, fy, cx, cy,
                     n_iters: int = 10, use_huber: bool = True,
                     cg_iters: int = 40, axis_name=None):
    """Scalable LM bundle adjustment: the reduced camera system is solved by
    preconditioned CG whose matvec is assembled from per-EDGE blocks
    (never materializing the dense [C,P,6,3] cross tensor of
    `bundle_adjust`) — cost O(E) per CG iteration, so it scales to
    thousands of cameras/points (full GBA after loop closure, KITTI-sized
    maps). Same interface/result contract as bundle_adjust.

    axis_name: if set, the EDGE list is sharded over that mesh axis
    (cameras/points replicated): every edge-reduced quantity — normal-
    equation blocks, gradients, the Schur matvec's cross terms, robust
    costs — is psum'd over the axis so each shard performs the identical
    solve. This is the multi-chip GBA (SURVEY.md §5: solves sharded over
    the device mesh); see parallel/ba_dist.py."""
    C = prob.Tcw.shape[0]
    P = prob.points.shape[0]
    f32 = prob.points.dtype
    free_cam = (~prob.cam_fixed) & prob.cam_valid

    def psum_(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    def cost_at(Tcw, X, xi_all, dX):
        p = prob._replace(Tcw=Tcw, points=X)
        e, _, _, z, is_st = _edge_residuals(xi_all, dX, p, fx, fy, cx, cy)
        cost, _ = _robust_cost(
            e, prob.e_inv_sigma2, prob.e_valid & (z > 0), use_huber, is_st)
        return psum_(cost)

    def lm_iter(it, state):
        Tcw, X, lam = state
        p = prob._replace(Tcw=Tcw, points=X)
        zero_xi = jnp.zeros((C, 6), f32)
        zero_dx = jnp.zeros((P, 3), f32)
        e, Jc, Jp, z, is_st = _edge_residuals(zero_xi, zero_dx, p,
                                              fx, fy, cx, cy)
        chi2 = jnp.sum(e * e, axis=1) * prob.e_inv_sigma2
        delta_e = jnp.where(is_st, HUBER_DELTA_STEREO, HUBER_DELTA)
        w_h = jnp.where(
            jnp.asarray(use_huber),
            jnp.minimum(1.0, delta_e / jnp.sqrt(jnp.maximum(chi2, 1e-12))),
            1.0)
        active = prob.e_valid & (z > 0)
        w = jnp.where(active, w_h * prob.e_inv_sigma2, 0.0)
        sw = jnp.sqrt(w)[:, None, None]
        Jc_w = Jc * sw                                   # weight-absorbed
        Jp_w = Jp * sw
        e_w = e * jnp.sqrt(w)[:, None]
        # Block diagonals (edge-sharded partials reduced over the mesh).
        Hcc = psum_(jnp.zeros((C, 6, 6), f32).at[prob.e_cam].add(
            jnp.einsum("eif,eig->efg", Jc_w, Jc_w)))
        Hpp = psum_(jnp.zeros((P, 3, 3), f32).at[prob.e_pt].add(
            jnp.einsum("eif,eig->efg", Jp_w, Jp_w)))
        gc = psum_(jnp.zeros((C, 6), f32).at[prob.e_cam].add(
            jnp.einsum("eif,ei->ef", Jc_w, e_w)))
        gp = psum_(jnp.zeros((P, 3), f32).at[prob.e_pt].add(
            jnp.einsum("eif,ei->ef", Jp_w, e_w)))
        Hcc_d = Hcc + lam * jnp.eye(6, dtype=f32)[None] * jnp.maximum(
            jnp.diagonal(Hcc, axis1=1, axis2=2), 1e-6)[:, :, None]
        Hpp_d = Hpp + lam * jnp.eye(3, dtype=f32)[None] * jnp.maximum(
            jnp.diagonal(Hpp, axis1=1, axis2=2), 1e-6)[:, :, None]
        Hpp_inv = _inv3x3(Hpp_d)
        pt_ok = prob.pt_valid & (jnp.einsum("pii->p", Hpp) > 1e-9)
        Hpp_inv = jnp.where(pt_ok[:, None, None], Hpp_inv, 0.0)
        fm = free_cam.astype(f32)[:, None]

        def A_t(x_c):
            """A^T x: [C,6] -> [P,3] via per-edge W^T."""
            u = jnp.einsum("eif,ei->ef", Jp_w,
                           jnp.einsum("eig,eg->ei", Jc_w, x_c[prob.e_cam]))
            return psum_(jnp.zeros((P, 3), f32).at[prob.e_pt].add(u))

        def A_(v_p):
            """A v: [P,3] -> [C,6]."""
            u = jnp.einsum("eif,ei->ef", Jc_w,
                           jnp.einsum("eig,eg->ei", Jp_w, v_p[prob.e_pt]))
            return psum_(jnp.zeros((C, 6), f32).at[prob.e_cam].add(u))

        def schur_mv(x_c):
            x_c = x_c * fm
            y = jnp.einsum("cab,cb->ca", Hcc_d, x_c)
            t = A_t(x_c)
            t = jnp.einsum("pab,pb->pa", Hpp_inv, t)
            y = y - A_(t)
            # Fixed cams act as identity (keeps PCG well-posed on them).
            y = y * fm + x_c * (1.0 - fm) + 0.0
            return y

        rhs = (-gc + A_(jnp.einsum("pab,pb->pa", Hpp_inv, gp))) * fm
        Minv = jnp.linalg.inv(Hcc_d + 1e-6 * jnp.eye(6, dtype=f32)[None])

        def precond(x):
            return jnp.einsum("cab,cb->ca", Minv, x) * fm

        x = jnp.zeros((C, 6), f32)
        r_cg = rhs
        zv = precond(r_cg)
        pv = zv
        rz = jnp.sum(r_cg * zv)

        def cg_body(_, st):
            x, r_cg, pv, rz = st
            Ap = schur_mv(pv)
            denom = jnp.sum(pv * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
            x = x + alpha * pv
            r_new = r_cg - alpha * Ap
            z_new = precond(r_new)
            rz_new = jnp.sum(r_new * z_new)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1e-12, rz)
            return x, r_new, z_new + beta * pv, rz_new

        dc, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                        (x, r_cg, pv, rz))
        dc = dc * fm
        dp = jnp.einsum("pab,pb->pa", Hpp_inv, -gp - A_t(dc))
        dp = jnp.where(pt_ok[:, None], dp, 0.0)
        cost0 = cost_at(Tcw, X, jnp.zeros((C, 6), f32), jnp.zeros((P, 3), f32))
        cost1 = cost_at(Tcw, X, dc, dp)
        improved = cost1 < cost0
        Tcw_new = jnp.where(improved, jax.vmap(lie.se3_exp)(dc) @ Tcw, Tcw)
        X_new = jnp.where(improved, X + dp, X)
        lam_new = jnp.clip(jnp.where(improved, lam * 0.5, lam * 4.0),
                           1e-10, 1e8)
        return Tcw_new, X_new, lam_new

    Tcw, X, _ = jax.lax.fori_loop(
        0, n_iters, lm_iter,
        (prob.Tcw.astype(f32), prob.points.astype(f32),
         jnp.asarray(1e-4, f32)))
    return Tcw, X


@jax.jit
def classify_outliers(Tcw, points, prob: BAProblem, fx, fy, cx, cy):
    """Per-edge chi2 gate (reference :692-738): returns bool[E] inlier mask
    (chi2 <= 5.991 and positive depth)."""
    p = prob._replace(Tcw=Tcw, points=points)
    C = Tcw.shape[0]
    P = points.shape[0]
    e, _, _, z, is_st = _edge_residuals(
        jnp.zeros((C, 6), points.dtype), jnp.zeros((P, 3), points.dtype),
        p, fx, fy, cx, cy)
    chi2 = jnp.sum(e * e, axis=1) * prob.e_inv_sigma2
    gate = jnp.where(is_st, CHI2_STEREO, CHI2_MONO)
    return prob.e_valid & (z > 0) & (chi2 <= gate), chi2


@jax.jit
def local_bundle_adjustment(prob: BAProblem, fx, fy, cx, cy):
    """The reference two-stage schedule (:636-738): 5 robust iterations,
    drop outlier edges, 10 more without re-adding them. Returns
    (Tcw, points, edge_inlier_mask).

    The whole schedule (both LM stages + both outlier classifications) is
    ONE fused device program: one dispatch and one fetch per keyframe."""
    Tcw, X = bundle_adjust(prob, fx, fy, cx, cy, n_iters=5, use_huber=True)
    inlier, _ = classify_outliers(Tcw, X, prob, fx, fy, cx, cy)
    prob2 = prob._replace(Tcw=Tcw, points=X, e_valid=inlier)
    Tcw, X = bundle_adjust(prob2, fx, fy, cx, cy, n_iters=10, use_huber=False)
    inlier, _ = classify_outliers(Tcw, X, prob2, fx, fy, cx, cy)
    return Tcw, X, inlier


@jax.jit
def local_bundle_adjustment_packed(prob: BAProblem, fx, fy, cx, cy):
    """local_bundle_adjustment with the three results PACKED into one flat
    f32 buffer [C*16 + P*3 + E]: the mapper fetches this once and splits
    on the host."""
    Tcw, X, inl = local_bundle_adjustment(prob, fx, fy, cx, cy)
    return jnp.concatenate([
        Tcw.reshape(-1), X.reshape(-1), inl.astype(X.dtype)])


def unpack_local_ba(buf, C: int, P: int, E: int):
    """Host-side split of local_bundle_adjustment_packed's buffer."""
    Tcw = buf[:C * 16].reshape(C, 4, 4)
    X = buf[C * 16:C * 16 + P * 3].reshape(P, 3)
    inl = buf[C * 16 + P * 3:] > 0.5
    return Tcw, X, inl


def global_bundle_adjustment(prob: BAProblem, fx, fy, cx, cy, n_iters=20):
    """Reference GlobalBundleAdjustemnt (:22-27): all cameras free except
    id 0, Huber kernel, n_iters iterations."""
    Tcw, X = bundle_adjust(prob, fx, fy, cx, cy, n_iters=n_iters, use_huber=True)
    inlier, _ = classify_outliers(Tcw, X, prob, fx, fy, cx, cy)
    return Tcw, X, inlier
