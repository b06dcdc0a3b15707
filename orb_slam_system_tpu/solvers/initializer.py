"""Two-view monocular initialization: parallel H/F RANSAC + reconstruction.

Replaces reference Initializer (src/Initializer.cc:16-77 Initialize,
ComputeH21 :171, ComputeF21 :211, CheckHomography :250, CheckFundamental
:330, ReconstructF :406-490, ReconstructH :493-651, CheckRT :725) with fully
batched device programs:

  * All 200 RANSAC hypotheses for BOTH models are evaluated in one pass each
    (vmapped 8-point DLT + dense scoring over all matches) instead of the
    reference's two host threads of sequential iterations (:68-71).
  * Model selection keeps the reference rule RH = SH/(SH+SF) > 0.40 (:72-76).
  * Reconstruction evaluates all 4 (F) / 8 (H) motion hypotheses with
    batched cheirality checks (CheckRT) in parallel.

RANSAC sample indices are generated host-side from a fixed seed, preserving
the reference's determinism intent (DUtils::Random::SeedRandOnce(0), :47).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

import numpy as np

SIGMA = 1.0                 # reference Initializer ctor sigma
TH_H = 5.991                # CheckHomography chi2 gate
TH_F = 3.841                # CheckFundamental chi2 gate
TH_SCORE = 5.991            # score cap used by both checks
MIN_PARALLAX_DEG = 1.0      # ReconstructF/H minParallax
MIN_TRIANGULATED = 50


class InitResult(NamedTuple):
    success: jnp.ndarray      # bool
    used_homography: jnp.ndarray  # bool
    R21: jnp.ndarray          # f32[3,3] cam1 -> cam2
    t21: jnp.ndarray          # f32[3] (unit-normalized)
    points3d: jnp.ndarray     # f32[M,3] in cam1 frame
    is_triangulated: jnp.ndarray  # bool[M]
    n_good: jnp.ndarray       # i32


def make_ransac_sets(n_matches_slots: int, n_sets: int = 200, k: int = 8,
                     seed: int = 0) -> np.ndarray:
    """Host-side deterministic RANSAC index sets [n_sets, k]; indices are
    drawn over slot range and remapped to valid matches on device."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max(n_matches_slots, 1), size=(n_sets, k)).astype(np.int32)


def _normalize(pts, valid):
    """Reference Normalize (src/Initializer.cc): zero-mean, unit mean-abs-dev
    per axis, over valid matches only. Returns (pts_n, T 3x3)."""
    w = valid.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.abs(pts - mean) * w[:, None]
    mean_dev = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(mean_dev, 1e-9)
    pts_n = (pts - mean) * s
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], pts.dtype)
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return pts_n, T


def _smallest_eigvec(AtA):
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[..., :, 0]


def _compute_h(p1, p2):
    """8-point homography DLT (reference ComputeH21): p1,p2 [8,2] normalized.
    Returns H [3,3] with p2 ~ H p1."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], axis=1)
    r2 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # [16,9]
    h = _smallest_eigvec(A.T @ A)
    return h.reshape(3, 3)


def _compute_f(p1, p2):
    """8-point fundamental DLT + rank-2 enforcement (reference ComputeF21)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    one = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=1
    )  # [8,9]
    f = _smallest_eigvec(A.T @ A)
    F = f.reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return (U * S[None, :]) @ Vt


def _score_h(H21, pts1, pts2, valid, sigma2):
    """Symmetric transfer error scoring (reference CheckHomography :250)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, a):
        ah = jnp.concatenate([a, jnp.ones((a.shape[0], 1), a.dtype)], axis=1)
        b = ah @ H.T
        w = b[:, 2]
        ws = jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)
        return b[:, :2] / ws[:, None]

    e21 = pts2 - transfer(H21, pts1)
    e12 = pts1 - transfer(H12, pts2)
    chi21 = jnp.sum(e21 * e21, axis=1) / sigma2
    chi12 = jnp.sum(e12 * e12, axis=1) / sigma2
    in21 = chi21 <= TH_H
    in12 = chi12 <= TH_H
    inlier = valid & in21 & in12
    score = jnp.sum(
        jnp.where(valid & in21, TH_SCORE - chi21, 0.0)
        + jnp.where(valid & in12, TH_SCORE - chi12, 0.0)
    )
    return score, inlier


def _score_f(F21, pts1, pts2, valid, sigma2):
    """Epipolar distance scoring (reference CheckFundamental :330)."""
    ones = jnp.ones((pts1.shape[0], 1), pts1.dtype)
    p1h = jnp.concatenate([pts1, ones], axis=1)
    p2h = jnp.concatenate([pts2, ones], axis=1)
    l2 = p1h @ F21.T          # line in image 2
    l1 = p2h @ F21            # line in image 1
    d2 = jnp.sum(l2 * p2h, axis=1) ** 2 / jnp.maximum(
        l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12)
    d1 = jnp.sum(l1 * p1h, axis=1) ** 2 / jnp.maximum(
        l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12)
    chi2_2 = d2 / sigma2
    chi2_1 = d1 / sigma2
    in2 = chi2_2 <= TH_F
    in1 = chi2_1 <= TH_F
    inlier = valid & in1 & in2
    score = jnp.sum(
        jnp.where(valid & in2, TH_SCORE - chi2_2, 0.0)
        + jnp.where(valid & in1, TH_SCORE - chi2_1, 0.0)
    )
    return score, inlier


def _check_rt(R, t, pts1, pts2, valid, K, sigma2):
    """Cheirality + reprojection test for a motion hypothesis (reference
    CheckRT :725): triangulate all valid matches with P1=K[I|0], P2=K[R|t],
    require finite, positive depth in both views, parallax cos < 0.99998,
    reprojection error < 4*sigma2 in both images. Returns
    (n_good, good mask, parallax_deg)."""
    from orb_slam_system_tpu.solvers.triangulate import triangulate_dlt

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    P1 = jnp.concatenate([K, jnp.zeros((3, 1), K.dtype)], axis=1)
    Rt = jnp.concatenate([R, t[:, None]], axis=1)
    P2 = K @ Rt
    X, w_ok = triangulate_dlt(pts1, pts2, P1, P2)
    finite = jnp.all(jnp.isfinite(X), axis=1) & w_ok
    O2 = -R.T @ t
    n1 = X
    n2 = X - O2[None, :]
    d1 = jnp.linalg.norm(n1, axis=1)
    d2 = jnp.linalg.norm(n2, axis=1)
    cos_par = jnp.sum(n1 * n2, axis=1) / jnp.maximum(d1 * d2, 1e-12)
    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]
    depth_ok = (z1 > 0) & (z2 > 0)
    has_parallax = cos_par < 0.99998

    def reproj_err(Xc, pts):
        zc = jnp.where(jnp.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        u = fx * Xc[:, 0] / zc + cx
        v = fy * Xc[:, 1] / zc + cy
        e = pts - jnp.stack([u, v], axis=1)
        return jnp.sum(e * e, axis=1)

    err1 = reproj_err(X, pts1)
    err2 = reproj_err(Xc2, pts2)
    good = (
        valid & finite & depth_ok & has_parallax
        & (err1 < 4.0 * sigma2) & (err2 < 4.0 * sigma2)
    )
    n_good = jnp.sum(good.astype(jnp.int32))
    # Parallax: 50th-smallest cosine among good points (reference :795-800).
    cp = jnp.where(good, cos_par, 1.0)
    cp_sorted = jnp.sort(cp)
    idx = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
    parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(cp_sorted[idx], -1.0, 1.0)))
    parallax_deg = jnp.where(n_good > 0, parallax_deg, 0.0)
    return n_good, good, parallax_deg, X


def _reconstruct_f(F21, pts1, pts2, inlier, K, sigma2):
    """Reference ReconstructF :406-490: E decomposition into 4 hypotheses,
    batched CheckRT, winner-take-all with ambiguity rejection."""
    E = K.T @ F21 @ K
    U, _, Vt = jnp.linalg.svd(E)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], K.dtype)
    R1 = U @ W @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    tu = U[:, 2]
    tu = tu / jnp.maximum(jnp.linalg.norm(tu), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([tu, -tu, tu, -tu])
    n_good, good, par, X = jax.vmap(
        lambda R, t: _check_rt(R, t, pts1, pts2, inlier, K, sigma2)
    )(Rs, ts)
    n_inl = jnp.sum(inlier.astype(jnp.int32))
    max_good = jnp.max(n_good)
    best = jnp.argmax(n_good)
    n_similar = jnp.sum((n_good > 0.7 * max_good).astype(jnp.int32))
    min_good = jnp.maximum(
        (0.9 * n_inl).astype(jnp.int32), MIN_TRIANGULATED)
    ok = (
        (max_good >= min_good)
        & (n_similar == 1)
        & (par[best] > MIN_PARALLAX_DEG)
    )
    return ok, Rs[best], ts[best], X[best], good[best], n_good[best]


def _reconstruct_h(H21, pts1, pts2, inlier, K, sigma2):
    """Reference ReconstructH :493-651 (Faugeras & Lustman 8-solution
    decomposition of A = K^-1 H K), batched CheckRT over all 8."""
    Kinv = jnp.linalg.inv(K)
    A = Kinv @ H21 @ K
    U, S, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]
    # x1/x3 magnitudes (x2 = 0).
    eps = 1e-12
    aux1 = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, eps), 0.0))
    aux3 = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, eps), 0.0))
    e1 = jnp.array([1.0, 1.0, -1.0, -1.0], K.dtype)
    e3 = jnp.array([1.0, -1.0, 1.0, -1.0], K.dtype)
    x1 = e1 * aux1
    x3 = e3 * aux3

    # Case d' = +d2 (4 solutions).
    sin_t = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 + d3) * d2, eps)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, eps)
    st = e1 * e3 * sin_t

    def make_Rt_pos(x1i, x3i, sti):
        Rp = jnp.array(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], K.dtype)
        Rp = Rp.at[0, 0].set(cos_t).at[0, 2].set(-sti)
        Rp = Rp.at[2, 0].set(sti).at[2, 2].set(cos_t)
        R = s * (U @ Rp @ Vt)
        tp = jnp.stack([x1i, jnp.zeros_like(x1i), -x3i]) * (d1 - d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), eps)

    # Case d' = -d2 (4 solutions).
    sin_p = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 - d3) * d2, eps)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, eps)
    sp = e1 * e3 * sin_p

    def make_Rt_neg(x1i, x3i, spi):
        Rp = jnp.zeros((3, 3), K.dtype)
        Rp = Rp.at[0, 0].set(cos_p).at[0, 2].set(spi)
        Rp = Rp.at[1, 1].set(-1.0)
        Rp = Rp.at[2, 0].set(spi).at[2, 2].set(-cos_p)
        R = s * (U @ Rp @ Vt)
        tp = jnp.stack([x1i, jnp.zeros_like(x1i), x3i]) * (d1 + d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), eps)

    Rp_list, tp_list = jax.vmap(make_Rt_pos)(x1, x3, st)
    Rn_list, tn_list = jax.vmap(make_Rt_neg)(x1, x3, sp)
    Rs = jnp.concatenate([Rp_list, Rn_list], axis=0)
    ts = jnp.concatenate([tp_list, tn_list], axis=0)
    n_good, good, par, X = jax.vmap(
        lambda R, t: _check_rt(R, t, pts1, pts2, inlier, K, sigma2)
    )(Rs, ts)
    n_inl = jnp.sum(inlier.astype(jnp.int32))
    best = jnp.argmax(n_good)
    best_good = n_good[best]
    # Second best.
    ng2 = n_good.at[best].set(-1)
    second_good = jnp.max(ng2)
    ok = (
        (second_good < 0.75 * best_good)
        & (par[best] > MIN_PARALLAX_DEG)
        & (best_good > MIN_TRIANGULATED)
        & (best_good > 0.9 * n_inl)
    )
    return ok, Rs[best], ts[best], X[best], good[best], best_good


@functools.partial(jax.jit, static_argnames=())
def initialize_two_view(
    pts1, pts2, valid, ransac_sets, K,
):
    """Full two-view bootstrap (reference Initialize :16-77).

    pts1/pts2: f32[M,2] undistorted pixel coords of the matched pairs (slot-
    aligned; `valid` marks real matches). ransac_sets: i32[S,8] precomputed
    index sets into the M slots. K: f32[3,3].

    Returns InitResult with the relative pose (R21, t21) and triangulated
    points in camera-1 coordinates.
    """
    sigma2 = SIGMA * SIGMA
    f32 = pts1.dtype
    # Remap RANSAC indices onto valid slots: build a compacted index list
    # (invalid slots point at the first valid one to keep shapes static).
    slot_ids = jnp.arange(pts1.shape[0], dtype=jnp.int32)
    valid_ids = jnp.where(valid, slot_ids, jnp.int32(1 << 28))
    order = jnp.argsort(valid_ids)          # valid slots first
    n_valid = jnp.sum(valid.astype(jnp.int32))
    sel = order[ransac_sets % jnp.maximum(n_valid, 1)]     # [S,8]

    p1n, T1 = _normalize(pts1, valid)
    p2n, T2 = _normalize(pts2, valid)
    T2inv = jnp.linalg.inv(T2)

    def per_set_h(idx):
        Hn = _compute_h(p1n[idx], p2n[idx])
        H21 = T2inv @ Hn @ T1
        score, _ = _score_h(H21, pts1, pts2, valid, sigma2)
        return score, H21

    def per_set_f(idx):
        Fn = _compute_f(p1n[idx], p2n[idx])
        F21 = T2.T @ Fn @ T1
        score, _ = _score_f(F21, pts1, pts2, valid, sigma2)
        return score, F21

    scores_h, Hs = jax.vmap(per_set_h)(sel)
    scores_f, Fs = jax.vmap(per_set_f)(sel)
    bi_h = jnp.argmax(scores_h)
    bi_f = jnp.argmax(scores_f)
    SH = scores_h[bi_h]
    SF = scores_f[bi_f]
    H21 = Hs[bi_h]
    F21 = Fs[bi_f]
    _, inlier_h = _score_h(H21, pts1, pts2, valid, sigma2)
    _, inlier_f = _score_f(F21, pts1, pts2, valid, sigma2)

    RH = SH / jnp.maximum(SH + SF, 1e-9)
    use_h = RH > 0.40    # reference :72-76

    ok_h, Rh, th, Xh, good_h, n_h = _reconstruct_h(
        H21, pts1, pts2, inlier_h, K, sigma2)
    ok_f, Rf, tf, Xf, good_f, n_f = _reconstruct_f(
        F21, pts1, pts2, inlier_f, K, sigma2)

    success = jnp.where(use_h, ok_h, ok_f)
    R21 = jnp.where(use_h, Rh, Rf)
    t21 = jnp.where(use_h, th, tf)
    X = jnp.where(use_h, Xh, Xf)
    good = jnp.where(use_h, good_h, good_f)
    n_good = jnp.where(use_h, n_h, n_f)
    return InitResult(
        success=success,
        used_homography=use_h,
        R21=R21.astype(f32),
        t21=t21.astype(f32),
        points3d=X.astype(f32),
        is_triangulated=good,
        n_good=n_good,
    )
