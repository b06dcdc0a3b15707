"""Sim3 solver: Horn closed-form absolute orientation + batched RANSAC.

Replaces reference Sim3Solver (src/Sim3Solver.cc): ComputeSim3 (:206-317,
Horn 1987 quaternion method with optional scale), RANSAC over 3-point
samples (iterate :120-187), inlier check by mutual reprojection with
chi2 9.210*sigma2 gates (ctor :67-68, CheckInliers :320).

Design: all RANSAC hypotheses solved in one vmapped pass; inlier checks
are dense batched projections.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

CHI2_SIM3 = 9.210  # reference Sim3Solver ctor :67-68


def horn_sim3(P1, P2, w, fix_scale: bool = False):
    """Closed-form similarity P1 ~ s * R @ P2 + t (maps frame-2 points into
    frame 1), weighted by w (0 excludes). Horn's quaternion method.

    Returns (s, R, t)."""
    f32 = P1.dtype
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mu1 = jnp.sum(P1 * w[:, None], axis=0) / wsum
    mu2 = jnp.sum(P2 * w[:, None], axis=0) / wsum
    Q1 = (P1 - mu1) * w[:, None]
    Q2 = P2 - mu2
    M = Q2.T @ Q1        # [3,3]: sum over points of q2 q1^T (weighted once)
    # Horn's 4x4 N matrix from M (note ordering q = [w, x, y, z] here).
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ], f32)
    _, vecs = jnp.linalg.eigh(N)
    q = vecs[:, -1]      # largest eigenvalue -> rotation quaternion [w,x,y,z]
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    R = jnp.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ], f32)
    # Scale (reference :272-291, symmetric formulation).
    RQ2 = Q2 @ R.T
    num = jnp.sum(((P1 - mu1) * w[:, None]) * RQ2)
    den = jnp.sum((Q2 * Q2) * w[:, None])
    s = jnp.where(fix_scale, jnp.asarray(1.0, f32),
                  num / jnp.maximum(den, 1e-12))
    t = mu1 - s * (R @ mu2)
    return s, R, t


def _project(P, fx, fy, cx, cy):
    z = jnp.where(jnp.abs(P[:, 2]) < 1e-9, 1e-9, P[:, 2])
    return jnp.stack([fx * P[:, 0] / z + cx, fy * P[:, 1] / z + cy], axis=1)


@jax.jit
def sim3_ransac(
    P1, P2, uv1, uv2, max_err1, max_err2, valid, sample_sets,
    fx, fy, cx, cy, fix_scale: jnp.ndarray = False,
    min_inliers: jnp.ndarray = 20,
):
    """Batched Sim3 RANSAC between two keyframes' matched map points.

    P1/P2: f32[N,3] camera-frame 3D points (KF1/KF2); uv1/uv2: their
    observed pixels; max_err*: 9.21*sigma2 per point (reference per-kp
    octave); sample_sets: i32[S,3].

    Returns (ok, s12, R12, t12, inliers bool[N], n_inliers): the similarity
    mapping KF2 camera points into KF1's frame.
    """
    N = P1.shape[0]
    f32 = P1.dtype
    slot_ids = jnp.arange(N, dtype=jnp.int32)
    order = jnp.argsort(jnp.where(valid, slot_ids, jnp.int32(1 << 28)))
    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    sel = order[sample_sets % n_valid]

    def check(s, R, t):
        # Mutual reprojection (reference CheckInliers :320).
        P2in1 = s * (P2 @ R.T) + t
        sinv = 1.0 / jnp.maximum(s, 1e-12)
        P1in2 = sinv * ((P1 - t) @ R)
        e1 = uv1 - _project(P2in1, fx, fy, cx, cy)
        e2 = uv2 - _project(P1in2, fx, fy, cx, cy)
        d1 = jnp.sum(e1 * e1, axis=1)
        d2 = jnp.sum(e2 * e2, axis=1)
        return valid & (d1 < max_err1) & (d2 < max_err2)

    def per_set(idx):
        w = jnp.zeros(N, f32).at[idx].set(1.0) * valid.astype(f32)
        s, R, t = horn_sim3(P1, P2, w, False)
        s = jnp.where(fix_scale, 1.0, s)
        inl = check(s, R, t)
        # Reject negative/degenerate scales.
        good = (s > 1e-3) & (s < 1e3)
        return jnp.where(good, jnp.sum(inl.astype(jnp.int32)), 0), s, R, t

    n_inl, ss, Rs, ts = jax.vmap(per_set)(sel)
    best = jnp.argmax(n_inl)
    s_b, R_b, t_b = ss[best], Rs[best], ts[best]
    inliers = check(s_b, R_b, t_b)
    # Refine on inliers.
    s_r, R_r, t_r = horn_sim3(P1, P2, inliers.astype(f32), False)
    s_r = jnp.where(fix_scale, 1.0, s_r)
    inl_r = check(s_r, R_r, t_r)
    use_r = jnp.sum(inl_r.astype(jnp.int32)) >= jnp.sum(inliers.astype(jnp.int32))
    s_f = jnp.where(use_r, s_r, s_b)
    R_f = jnp.where(use_r, R_r, R_b)
    t_f = jnp.where(use_r, t_r, t_b)
    inl_f = jnp.where(use_r, inl_r, inliers)
    n_f = jnp.sum(inl_f.astype(jnp.int32))
    return n_f >= min_inliers, s_f, R_f, t_f, inl_f, n_f


@jax.jit
def sim3_ransac_batch(
    P1, P2, uv1, uv2, max_err1, max_err2, valid, sample_sets,
    fx, fy, cx, cy, fix_scale: jnp.ndarray = False,
    min_inliers: jnp.ndarray = 20,
):
    """sim3_ransac vmapped over C candidate pairs in ONE device program
    with ONE packed result (the loop closer's ComputeSim3 used to run
    RANSAC candidate-by-candidate, reference src/LoopClosing.cc:127-208 —
    each a device round trip). Point args carry a leading [C] axis;
    sample_sets/camera are shared. Returns f32[C, 14 + N]:
    [ok, s, R(9), t(3), inliers(N)] per candidate."""
    def one(p1, p2, u1, u2, m1, m2, v):
        ok, s, R, t, inl, _n = sim3_ransac(
            p1, p2, u1, u2, m1, m2, v, sample_sets,
            fx, fy, cx, cy, fix_scale, min_inliers)
        return jnp.concatenate([
            jnp.stack([ok.astype(p1.dtype), s.astype(p1.dtype)]),
            R.reshape(-1), t, inl.astype(p1.dtype)])

    return jax.vmap(one)(P1, P2, uv1, uv2, max_err1, max_err2, valid)


def make_sim3_sample_sets(n_slots: int, n_sets: int = 300, seed: int = 0):
    """Reference RANSAC(0.99, 20, 300) (src/LoopClosing.cc:156)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max(n_slots, 1), size=(n_sets, 3)).astype(np.int32)
