"""Fused keyframe-insertion device programs: triangulation + fusion.

The local mapper's per-keyframe device work used to run as THREE separate
programs (epipolar search + DLT, its host-side acceptance gates, then the
neighbor-fusion projection search), each paying one device round trip
plus host gate time. This module runs the
whole tri+fuse pipeline with ONE packed fetch:

  * `tri_step`: epipolar triangulation search against the M covisible
    neighbors (reference LocalMapping::CreateNewMapPoints
    src/LocalMapping.cc:166-233 + ORBmatcher::SearchForTriangulation
    src/ORBmatcher.cc:368-467), batched two-view DLT, ALL acceptance
    gates (parallax, cheirality, reprojection chi2, scale consistency —
    reference :219-233) and the cross-neighbor winner per feature slot —
    on device, returning a DEVICE-RESIDENT [N1, 6] block.
  * `fuse_step`: SearchInNeighbors fusion (reference :235-293 +
    ORBmatcher::Fuse :504-568) consuming `tri_step`'s block WITHOUT a
    host round trip: direction A projects the current keyframe's map
    points — including the just-accepted points, whose world positions,
    normals and scale bands are computed in-program from the block —
    into every fuse target; direction B projects the targets' point
    union into the current keyframe. Its packed output carries the tri
    block along, so the host fetches EVERYTHING in one array.

Two chained programs instead of one deliberately: a single program keyed
its compile on the PRODUCT of all size axes (neighbors x targets x
union-size x slot counts), and every fresh combination cost a multi-
second XLA compile in the frame loop; chaining keys each program on its
own axes only (sum, not product).

The host then creates the accepted points and applies the fuse merges
(arena bookkeeping stays host-side and authoritative).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.ops import matching
from orb_slam_system_tpu.solvers.triangulate import triangulate_dlt

CHI2_MONO = 5.991


def _project_for_fuse(R, t, ctr, w, h, fx, fy, cx, cy,
                      pos, normal, mind, maxd, ok,
                      log_sf, scale_factors, radius_th):
    """Fuse-projection geometry vectorized over [T] cameras x [P] points
    (device port of the host's _project_for_fuse_many; reference
    ORBmatcher::Fuse :504-548 gates: in-front, in-image, scale-invariance
    distance band, viewing angle < 60 deg, predicted level + radius).

    mind/maxd are the pre-scaled 0.8*min_dist / max(1.2*max_dist, 1e-6)
    bands. Returns (proj f32[T,P,2], radius f32[T,P], lvl i32[T,P],
    good bool[T,P])."""
    L = scale_factors.shape[0]
    Xc = jnp.einsum("tij,pj->tpi", R, pos) + t[:, None, :]     # [T,P,3]
    z = Xc[..., 2]
    good = ok[None, :] & (z > 0)
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = Xc[..., :2] / zs[..., None]
    proj = proj * jnp.stack([fx, fy]) + jnp.stack([cx, cy])
    good &= ((proj[..., 0] >= 0) & (proj[..., 0] < w)
             & (proj[..., 1] >= 0) & (proj[..., 1] < h))
    PO = pos[None, :, :] - ctr[:, None, :]                      # [T,P,3]
    dist = jnp.linalg.norm(PO, axis=2)
    good &= (dist >= mind[None]) & (dist <= maxd[None])
    good &= jnp.sum(PO * normal[None], axis=2) >= 0.5 * dist
    lvl = jnp.ceil(
        jnp.log(jnp.maximum(maxd[None] / 1.2, 1e-9)
                / jnp.maximum(dist, 1e-9)) / log_sf)
    lvl = jnp.clip(jnp.nan_to_num(lvl, nan=0.0), 0, L - 1).astype(jnp.int32)
    radius = radius_th * scale_factors[lvl]
    return proj.astype(jnp.float32), radius.astype(jnp.float32), lvl, good


def _tri_gates(xy1, oct1, nb_xy, nb_oct, idx2, X, okd,
               Tcw1, nb_Tcw, O1, nb_O, Kinv,
               fx, fy, cx, cy, inv_sigma2, scale_factors, ratio_factor):
    """Device port of the host acceptance gates (_triangulate_matches;
    reference CreateNewMapPoints :219-233) vectorized over [M, N1]."""
    M, N1 = idx2.shape
    sel = jnp.where(idx2 >= 0, idx2, 0)
    uv1 = xy1                                                   # [N1,2]
    uv2 = jnp.take_along_axis(nb_xy, sel[..., None], axis=1)    # [M,N1,2]
    oct2 = jnp.take_along_axis(nb_oct, sel, axis=1)             # [M,N1]
    ok = okd & (idx2 >= 0)
    # Ray parallax.
    ones1 = jnp.ones((N1, 1), jnp.float32)
    r1 = (jnp.concatenate([uv1, ones1], 1) @ Kinv.T) @ Tcw1[:3, :3]  # [N1,3]
    onesM = jnp.ones((M, N1, 1), jnp.float32)
    r2 = jnp.einsum("mnj,mjk->mnk",
                    jnp.einsum("mni,ji->mnj",
                               jnp.concatenate([uv2, onesM], -1), Kinv),
                    nb_Tcw[:, :3, :3])                           # [M,N1,3]
    cosp = jnp.sum(r1[None] * r2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1)[None] * jnp.linalg.norm(r2, axis=-1),
        1e-12)
    ok &= (cosp > 0) & (cosp < 0.9998)
    # Cheirality both views.
    z1 = X @ Tcw1[2, :3] + Tcw1[2, 3]                           # [M,N1]
    z2 = (jnp.einsum("mnj,mj->mn", X, nb_Tcw[:, 2, :3])
          + nb_Tcw[:, 2, 3][:, None])
    ok &= (z1 > 0) & (z2 > 0)
    # Reprojection chi2, view 1.
    Xc1 = jnp.einsum("mnj,ij->mni", X, Tcw1[:3, :3]) + Tcw1[:3, 3]
    zs1 = jnp.where(jnp.abs(Xc1[..., 2]) < 1e-12, 1e-12, Xc1[..., 2])
    u1 = fx * Xc1[..., 0] / zs1 + cx
    v1 = fy * Xc1[..., 1] / zs1 + cy
    e1 = (uv1[None, :, 0] - u1) ** 2 + (uv1[None, :, 1] - v1) ** 2
    ok &= e1 * inv_sigma2[oct1][None] <= CHI2_MONO
    # Reprojection chi2, view 2.
    Xc2 = jnp.einsum("mnj,mij->mni", X, nb_Tcw[:, :3, :3]) + \
        nb_Tcw[:, None, :3, 3]
    zs2 = jnp.where(jnp.abs(Xc2[..., 2]) < 1e-12, 1e-12, Xc2[..., 2])
    u2 = fx * Xc2[..., 0] / zs2 + cx
    v2 = fy * Xc2[..., 1] / zs2 + cy
    e2 = (uv2[..., 0] - u2) ** 2 + (uv2[..., 1] - v2) ** 2
    ok &= e2 * inv_sigma2[oct2] <= CHI2_MONO
    # Scale consistency.
    d1 = jnp.linalg.norm(X - O1[None, None, :], axis=-1)
    d2 = jnp.linalg.norm(X - nb_O[:, None, :], axis=-1)
    ok &= (d1 > 0) & (d2 > 0)
    ratio_dist = d2 / jnp.maximum(d1, 1e-12)
    ratio_oct = scale_factors[oct1][None] / scale_factors[oct2]
    ok &= ~((ratio_dist * ratio_factor < ratio_oct)
            | (ratio_dist > ratio_oct * ratio_factor))
    return ok


@jax.jit
def tri_step(
    xy1, desc1, avail1, oct1, ang1,
    nb_xy, nb_desc, nb_avail, nb_oct, nb_ang,
    F12, epipole, nb_valid, P1, P2,
    Tcw1, nb_Tcw, O1, nb_O,
    Kinv, fx, fy, cx, cy,
    inv_sigma2, scale_factors, ratio_factor,
):
    """Triangulation search + DLT + gates + first-neighbor-wins claims.
    Returns a device-resident f32[N1, 6] block:
    (accepted, winner_m, idx2, X, Y, Z) per feature slot."""
    N1 = xy1.shape[0]
    M = nb_xy.shape[0]
    idx2 = matching.search_for_triangulation_batch(
        xy1, desc1, avail1, oct1, ang1,
        nb_xy, nb_desc, nb_avail, nb_oct, nb_ang,
        F12, inv_sigma2, epipole, nb_valid)
    sel = jnp.where(idx2 >= 0, idx2, 0)
    uv2 = jnp.take_along_axis(nb_xy, sel[..., None], axis=1)    # [M,N1,2]
    X, okd = jax.vmap(triangulate_dlt, in_axes=(None, 0, None, 0))(
        xy1, uv2, P1, P2)
    ok = _tri_gates(xy1, oct1, nb_xy, nb_oct, idx2, X, okd,
                    Tcw1, nb_Tcw, O1, nb_O, Kinv,
                    fx, fy, cx, cy, inv_sigma2, scale_factors,
                    ratio_factor)
    ok &= nb_valid[:, None]
    # First-neighbor-wins claim per slot (the sequential reference
    # processes neighbors in covisibility order and skips slots already
    # claimed by an earlier neighbor).
    m_rank = jnp.where(ok, jnp.arange(M, dtype=jnp.int32)[:, None], M)
    mwin = jnp.min(m_rank, axis=0)                              # [N1]
    new_ok = mwin < M
    mw = jnp.where(new_ok, mwin, 0)
    rows = jnp.arange(N1)
    Xn = X[mw, rows]                                            # [N1,3]
    idx2n = jnp.where(new_ok, idx2[mw, rows], -1)
    return jnp.concatenate([
        new_ok[:, None].astype(jnp.float32),
        mwin[:, None].astype(jnp.float32),
        idx2n[:, None].astype(jnp.float32),
        Xn.astype(jnp.float32)], axis=1)                        # [N1,6]


@jax.jit
def fuse_step(
    tri_block,                                   # f32[N1,6] from tri_step
    xy1, desc1, valid1, oct1,
    Tcw1, O1, nb_O,
    fx, fy, cx, cy, w, h,
    scale_factors, log_sf,
    # fuse targets [T]
    tg_xy, tg_desc, tg_valid, tg_oct, tg_R, tg_t, tg_ctr, tg_mask,
    # direction A: the current KF's bound points, SLOT-ALIGNED [N1]
    A_pos, A_desc, A_mind, A_maxd, A_normal, A_ok,
    # direction B: target point union projected into the current KF [PB]
    B_pos, B_desc, B_mind, B_maxd, B_normal, B_ok,
    radius_th=3.0,
):
    """Both fusion directions, consuming tri_step's device block. Returns
    ONE packed f32 vector [N1*6 tri | T*(2*N1) direction-A idx | PB
    direction-B idx] — the single fetch of the whole insertion."""
    N1 = xy1.shape[0]
    T = tg_xy.shape[0]
    new_ok = tri_block[:, 0] > 0.5
    mw = jnp.where(new_ok, tri_block[:, 1], 0).astype(jnp.int32)
    Xn = tri_block[:, 3:6]
    # New-point attributes, matching what the arena computes at creation
    # (MapPoint ctor + UpdateNormalAndDepth, reference
    # src/MapPoint.cc:301-351: band anchored at the creating keyframe's
    # viewpoint/octave; normal = mean unit ray of the 2 observations).
    L = scale_factors.shape[0]
    dist1 = jnp.maximum(jnp.linalg.norm(Xn - O1[None], axis=1), 1e-9)
    maxd_n = dist1 * scale_factors[oct1]
    mind_n = maxd_n / scale_factors[L - 1]
    v1 = (Xn - O1[None]) / dist1[:, None]
    O2n = nb_O[mw]
    d2n = jnp.maximum(jnp.linalg.norm(Xn - O2n, axis=1), 1e-9)
    v2 = (Xn - O2n) / d2n[:, None]
    normal_n = 0.5 * (v1 + v2)
    # Direction A: old bound points (slot-aligned) + the new points.
    posA = jnp.concatenate([A_pos, Xn.astype(jnp.float32)])
    descA = jnp.concatenate([A_desc, desc1])
    mindA = jnp.concatenate([A_mind, (0.8 * mind_n).astype(jnp.float32)])
    maxdA = jnp.concatenate(
        [A_maxd, jnp.maximum(1.2 * maxd_n, 1e-6).astype(jnp.float32)])
    normalA = jnp.concatenate([A_normal, normal_n.astype(jnp.float32)])
    okA = jnp.concatenate([A_ok, new_ok])
    projA, radA, lvlA, goodA = _project_for_fuse(
        tg_R, tg_t, tg_ctr, w, h, fx, fy, cx, cy,
        posA, normalA, mindA, maxdA, okA, log_sf, scale_factors, radius_th)
    goodA &= tg_mask[:, None]
    idxA = matching.search_by_projection_set_batch(
        projA, radA, lvlA, goodA,
        jnp.broadcast_to(descA[None], (T,) + descA.shape),
        tg_xy, tg_desc, tg_valid, tg_oct,
        jnp.zeros((T, tg_xy.shape[1]), bool))                   # [T,2*N1]
    # Direction B: target point union into the current keyframe.
    projB, radB, lvlB, goodB = _project_for_fuse(
        Tcw1[None, :3, :3], Tcw1[None, :3, 3], O1[None], w, h,
        fx, fy, cx, cy, B_pos, B_normal, B_mind, B_maxd, B_ok,
        log_sf, scale_factors, radius_th)
    resB = matching.search_by_projection_set(
        projB[0], radB[0], lvlB[0], goodB[0], B_desc,
        xy1, desc1, valid1, oct1,
        jnp.zeros(N1, bool), max_dist=matching.TH_LOW)
    return jnp.concatenate([
        tri_block.reshape(-1),
        idxA.astype(jnp.float32).reshape(-1),
        resB.idx2.astype(jnp.float32)])


def unpack_tri_fuse(buf, N1: int, T: int, PA: int, PB: int,
                    do_fuse: bool = True):
    """Host split of the packed buffer (fuse_step's output, or tri_step's
    block alone when fusion was skipped). Returns
    (tri [N1,6], idxA i64[T,PA] or None, idxB i64[PB] or None)."""
    tri = buf[:N1 * 6].reshape(N1, 6)
    if not do_fuse:
        return tri, None, None
    off = N1 * 6
    idxA = buf[off:off + T * PA].reshape(T, PA).astype(np.int64)
    idxB = buf[off + T * PA:].astype(np.int64)
    return tri, idxA, idxB
