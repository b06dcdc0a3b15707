"""EPnP + RANSAC: absolute pose from 3D-2D correspondences.

Replaces reference PnPsolver (src/PnPsolver.cc): EPnP (Lepetit et al. 2009 —
4 control points, barycentric coordinates, 12x12 null-space, beta
refinement) wrapped in adaptive RANSAC (SetRansacParameters :70-106,
iterate :114-207), used by relocalization (src/Tracking.cc:796-884).

Design (SURVEY.md §7.1): ALL RANSAC hypotheses are evaluated in one
batched pass — S vmapped EPnP solves on 4-point minimal sets + dense inlier
scoring over all correspondences — instead of the reference's sequential
early-exit loop. A final refinement re-runs EPnP on the best hypothesis's
inliers (reference Refine :209) via an inlier-weighted solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

CHI2_GATE = 5.991  # per-point gate scaled by octave sigma2 (reference :103-105)


def _control_points(Xw, w):
    """4 control points: weighted centroid + principal directions."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    c0 = jnp.sum(Xw * w[:, None], axis=0) / wsum
    Xc = (Xw - c0) * jnp.sqrt(w)[:, None]
    cov = Xc.T @ Xc / wsum
    eigval, eigvec = jnp.linalg.eigh(cov)
    # Scale by sqrt of eigenvalues (PCA frame), guard degenerate.
    s = jnp.sqrt(jnp.maximum(eigval, 1e-9))
    C = c0[None, :] + (eigvec * s[None, :]).T   # [3,3] rows = offsets
    return jnp.concatenate([c0[None], c0[None] + (eigvec * s[None, :]).T], axis=0)


def _barycentric(Xw, ctrl):
    """alphas [N,4] with Xw = sum_j alpha_j * ctrl_j, sum alpha = 1."""
    M = jnp.concatenate([ctrl.T, jnp.ones((1, 4), ctrl.dtype)], axis=0)  # [4,4]
    Xh = jnp.concatenate([Xw, jnp.ones((Xw.shape[0], 1), Xw.dtype)], axis=1)
    return jnp.linalg.solve(M, Xh.T).T  # [N,4]


def _epnp_solve(Xw, uv, w, fx, fy, cx, cy):
    """Weighted EPnP: returns (R, t). w: per-point weights (0 excludes)."""
    ctrl = _control_points(Xw, w)
    alphas = _barycentric(Xw, ctrl)                  # [N,4]
    N = Xw.shape[0]
    sw = jnp.sqrt(jnp.maximum(w, 0.0))
    # Build M [2N, 12]: rows for u and v equations.
    a = alphas
    u = uv[:, 0]
    v = uv[:, 1]
    zero = jnp.zeros_like(a)
    row_u = jnp.concatenate(
        [a * fx, zero, a * (cx - u)[:, None]], axis=1)   # [N,12] (order: x,y,z per cp? see note)
    row_v = jnp.concatenate(
        [zero, a * fy, a * (cy - v)[:, None]], axis=1)
    # Note: columns grouped as [fx*alpha (x of cps), fy*alpha (y), (c-u)*alpha (z)]
    # -> unknown vector is [x1..x4, y1..y4, z1..z4] of camera-frame cps.
    M = jnp.concatenate([row_u * sw[:, None], row_v * sw[:, None]], axis=0)
    MtM = M.T @ M
    _, vecs = jnp.linalg.eigh(MtM)
    # N=1 case of EPnP: single smallest eigenvector with scale from betas.
    # (The full EPnP handles nullspace dims 1-4 via beta Gauss-Newton; with
    # >=6-point samples the nullspace is effectively 1-dim, so RANSAC uses
    # 6-point minimal sets here — same batched-hypothesis contract.)
    vker = vecs[:, 0]
    cps_cam = jnp.stack([vker[0:4], vker[4:8], vker[8:12]], axis=1)  # [4,3]
    # Resolve scale + sign: distances between control points must match.
    d_w = jnp.linalg.norm(ctrl[:, None, :] - ctrl[None, :, :], axis=-1)
    d_c = jnp.linalg.norm(cps_cam[:, None, :] - cps_cam[None, :, :], axis=-1)
    iu = jnp.triu_indices(4, 1)
    beta = jnp.sum(d_w[iu] * d_c[iu]) / jnp.maximum(jnp.sum(d_c[iu] ** 2), 1e-12)
    cps_cam = cps_cam * beta
    # Sign: points must be in front (positive mean z of reconstructed pts).
    pts_cam = alphas @ cps_cam                        # [N,3]
    sign = jnp.where(jnp.sum(pts_cam[:, 2] * w) < 0, -1.0, 1.0)
    pts_cam = pts_cam * sign
    # Horn alignment world->camera (Umeyama without scale).
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mu_w = jnp.sum(Xw * w[:, None], axis=0) / wsum
    mu_c = jnp.sum(pts_cam * w[:, None], axis=0) / wsum
    cov = ((pts_cam - mu_c) * w[:, None]).T @ (Xw - mu_w) / wsum
    U, _, Vt = jnp.linalg.svd(cov)
    S = jnp.eye(3, dtype=Xw.dtype)
    S = S.at[2, 2].set(jnp.sign(jnp.linalg.det(U @ Vt)))
    R = U @ S @ Vt
    t = mu_c - R @ mu_w
    return R, t


def _reproj_chi2(R, t, Xw, uv, inv_sigma2, fx, fy, cx, cy):
    Xc = Xw @ R.T + t
    z = Xc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * Xc[:, 0] / zs + cx
    v = fy * Xc[:, 1] / zs + cy
    e = uv - jnp.stack([u, v], axis=1)
    return jnp.sum(e * e, axis=1) * inv_sigma2, z


@jax.jit
def epnp_ransac(Xw, uv, inv_sigma2, valid, sample_sets, fx, fy, cx, cy,
                min_inliers: jnp.ndarray = 10):
    """Batched EPnP-RANSAC.

    Xw f32[N,3], uv f32[N,2], inv_sigma2 f32[N], valid bool[N];
    sample_sets i32[S,K] minimal-set indices (host-generated, deterministic;
    K=6 — see note in _epnp_solve).
    Returns (ok, Tcw f32[4,4], inliers bool[N], n_inliers).
    """
    N = Xw.shape[0]
    f32 = Xw.dtype
    # Remap sample indices onto valid slots.
    slot_ids = jnp.arange(N, dtype=jnp.int32)
    order = jnp.argsort(jnp.where(valid, slot_ids, jnp.int32(1 << 28)))
    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    sel = order[sample_sets % n_valid]                  # [S,4]

    def per_set(idx):
        w = jnp.zeros(N, f32).at[idx].set(1.0) * valid.astype(f32)
        R, t = _epnp_solve(Xw, uv, w, fx, fy, cx, cy)
        chi2, z = _reproj_chi2(R, t, Xw, uv, inv_sigma2, fx, fy, cx, cy)
        inl = valid & (chi2 <= CHI2_GATE) & (z > 0)
        return jnp.sum(inl.astype(jnp.int32)), R, t

    n_inl, Rs, ts = jax.vmap(per_set)(sel)
    best = jnp.argmax(n_inl)
    R_best, t_best = Rs[best], ts[best]
    chi2, z = _reproj_chi2(R_best, t_best, Xw, uv, inv_sigma2, fx, fy, cx, cy)
    inliers = valid & (chi2 <= CHI2_GATE) & (z > 0)
    # Refine on all inliers (reference Refine :209).
    w_ref = inliers.astype(f32)
    R_ref, t_ref = _epnp_solve(Xw, uv, w_ref, fx, fy, cx, cy)
    chi2r, zr = _reproj_chi2(R_ref, t_ref, Xw, uv, inv_sigma2, fx, fy, cx, cy)
    inliers_r = valid & (chi2r <= CHI2_GATE) & (zr > 0)
    use_ref = jnp.sum(inliers_r.astype(jnp.int32)) >= jnp.sum(
        inliers.astype(jnp.int32))
    R_f = jnp.where(use_ref, R_ref, R_best)
    t_f = jnp.where(use_ref, t_ref, t_best)
    inl_f = jnp.where(use_ref, inliers_r, inliers)
    n_f = jnp.sum(inl_f.astype(jnp.int32))
    T = jnp.eye(4, dtype=f32)
    T = T.at[:3, :3].set(R_f)
    T = T.at[:3, 3].set(t_f)
    return n_f >= min_inliers, T, inl_f, n_f


@jax.jit
def epnp_ransac_batch(Xw, uv, inv_sigma2, valid, sample_sets,
                      fx, fy, cx, cy, min_inliers: jnp.ndarray = 10):
    """epnp_ransac vmapped over C candidate hypotheses that share the same
    current-frame observations: Xw f32[C,N,3] and valid bool[C,N] carry the
    per-candidate 3D associations; uv/inv_sigma2/sample_sets broadcast.
    One device call replaces the reference's per-candidate PnPsolver loop
    (src/Tracking.cc:820-860), so relocalization needs no candidate cap.
    Returns (ok[C], Tcw[C,4,4], inliers[C,N], n_inliers[C])."""
    return jax.vmap(
        lambda X, v: epnp_ransac(X, uv, inv_sigma2, v, sample_sets,
                                 fx, fy, cx, cy, min_inliers)
    )(Xw, valid)


def make_pnp_sample_sets(n_slots: int, n_sets: int = 300, seed: int = 0):
    """Deterministic minimal sets (reference RANSAC 300 iters max,
    src/Tracking.cc:822 SetRansacParameters(0.99, 10, 300, 4, 0.5, 5.991))."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max(n_slots, 1), size=(n_sets, 6)).astype(np.int32)
