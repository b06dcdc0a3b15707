"""Guided descriptor matching — a dense, batched ORBmatcher.

Replaces reference ORBmatcher (src/ORBmatcher.cc) search entry points. Every
variant is the same dense program shape: one Hamming distance matrix over
padded keypoint sets + a boolean candidate mask encoding the variant's
geometric gating (search window / octave band / epipolar distance /
projection radius) + vectorized best/second-best reductions + an optional
rotation-consistency histogram — instead of per-keypoint grid walks.

Thresholds preserved from the reference (src/ORBmatcher.cc:13-15):
TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.ops.hamming import distance_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

_BIG = jnp.int32(1 << 20)


class MatchResult(NamedTuple):
    idx2: jnp.ndarray   # i32[N1] best index in set 2 (-1 if unmatched)
    dist: jnp.ndarray   # i32[N1] Hamming distance of the match


def _masked_best2(D: jnp.ndarray, mask: jnp.ndarray):
    """Per-row best and second-best over masked columns.
    Returns (best_j, best_d, second_d)."""
    Dm = jnp.where(mask, D, _BIG)
    best_j = jnp.argmin(Dm, axis=1)
    best_d = jnp.min(Dm, axis=1)
    # Second best: mask out the argmin column per row.
    cols = jnp.arange(D.shape[1])[None, :]
    Dm2 = jnp.where(cols == best_j[:, None], _BIG, Dm)
    second_d = jnp.min(Dm2, axis=1)
    return best_j, best_d, second_d


def rotation_consistency(ang1: jnp.ndarray, ang2_at_match: jnp.ndarray,
                         matched: jnp.ndarray) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the 3 most popular
    of HISTO_LENGTH orientation bins (reference ComputeThreeMaxima,
    src/ORBmatcher.cc:469-502; also fixes the fork's negative-angle bug §0.1
    row 9 by wrapping before binning).

    ang*: radians. matched: bool[N1]. Returns refined bool[N1]."""
    rot = ang1 - ang2_at_match
    rot = jnp.where(rot < 0, rot + 2 * jnp.pi, rot)
    bin_f = rot * (HISTO_LENGTH / (2 * jnp.pi))
    bins = jnp.clip(jnp.round(bin_f).astype(jnp.int32) % HISTO_LENGTH, 0,
                    HISTO_LENGTH - 1)
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(
        matched.astype(jnp.int32))
    # Top-3 bins, with the reference's pruning: drop bin2/bin3 if their count
    # is < 0.1x the max bin (src/ORBmatcher.cc:492-500).
    top_vals, top_idx = jax.lax.top_k(hist, 3)
    keep2 = top_vals[1] >= 0.1 * top_vals[0]
    keep3 = top_vals[2] >= 0.1 * top_vals[0]
    ok = (
        (bins == top_idx[0])
        | ((bins == top_idx[1]) & keep2)
        | ((bins == top_idx[2]) & keep3)
    )
    return matched & ok


def _dedupe_keep_best(best_j, best_d, matched, n2: int):
    """Enforce at most one match per column: keep the row with min distance
    for each claimed column (vectorized replacement for the reference's
    vnMatches21 bookkeeping, src/ORBmatcher.cc:241-252)."""
    d_for_scatter = jnp.where(matched, best_d, _BIG)
    col_min = jnp.full((n2,), _BIG, jnp.int32).at[best_j].min(d_for_scatter)
    keep = matched & (best_d <= col_min[best_j])
    # Among equal-distance duplicates keep the lowest row index.
    row_ids = jnp.arange(best_j.shape[0], dtype=jnp.int32)
    r_for_scatter = jnp.where(keep, row_ids, jnp.int32(1 << 28))
    col_row = jnp.full((n2,), 1 << 28, jnp.int32).at[best_j].min(r_for_scatter)
    return keep & (col_row[best_j] == row_ids)


@jax.jit
def search_for_initialization(
    xy1, desc1, valid1, oct1, ang1,
    xy2, desc2, valid2, oct2, ang2,
    prev_matched_xy,
    window_size: jnp.ndarray = 100,
    nn_ratio: jnp.ndarray = 0.9,
):
    """Monocular-initialization window search (reference
    SearchForInitialization, src/ORBmatcher.cc:197-276): level-0 keypoints
    only, square window around the previous matched position, TH_LOW gate,
    best<ratio*second, one-to-one, rotation histogram.

    Returns MatchResult over set 1 (the reference frame).
    """
    D = distance_matrix(desc1, desc2)
    dx = jnp.abs(xy2[None, :, 0] - prev_matched_xy[:, None, 0])
    dy = jnp.abs(xy2[None, :, 1] - prev_matched_xy[:, None, 1])
    mask = (
        valid1[:, None] & valid2[None, :]
        & (oct1[:, None] == 0) & (oct2[None, :] == 0)
        & (dx <= window_size) & (dy <= window_size)
    )
    best_j, best_d, second_d = _masked_best2(D, mask)
    matched = (
        (best_d <= TH_LOW)
        & (best_d.astype(jnp.float32) < nn_ratio * second_d.astype(jnp.float32))
        & valid1
    )
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[0])
    matched = rotation_consistency(ang1, ang2[best_j], matched)
    return MatchResult(jnp.where(matched, best_j, -1), best_d)


@jax.jit
def search_by_projection_motion(
    proj_xy, radius, pt_valid, desc_prev, oct_prev, ang_prev,
    xy2, desc2, valid2, oct2, ang2,
):
    """Motion-model guided search (reference SearchByProjection(Frame,Frame),
    src/ORBmatcher.cc:732-818): for each last-frame map point projected into
    the current frame at `proj_xy` with search `radius` (th * scale^octave),
    match current keypoints within the window and octave band [o-1, o+1],
    TH_HIGH gate, one-to-one, rotation histogram.

    Returns MatchResult over the previous-frame points.
    """
    D = distance_matrix(desc_prev, desc2)
    dx = jnp.abs(xy2[None, :, 0] - proj_xy[:, None, 0])
    dy = jnp.abs(xy2[None, :, 1] - proj_xy[:, None, 1])
    in_window = (dx <= radius[:, None]) & (dy <= radius[:, None])
    oct_band = (oct2[None, :] >= oct_prev[:, None] - 1) & (
        oct2[None, :] <= oct_prev[:, None] + 1
    )
    mask = pt_valid[:, None] & valid2[None, :] & in_window & oct_band
    best_j, best_d, _ = _masked_best2(D, mask)
    matched = (best_d <= TH_HIGH) & pt_valid
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[0])
    matched = rotation_consistency(ang_prev, ang2[best_j], matched)
    return MatchResult(jnp.where(matched, best_j, -1), best_d)


@jax.jit
def search_by_projection_local_map(
    proj_xy, radius, pred_level, pt_valid, desc_mp,
    xy2, desc2, valid2, oct2, already_matched2,
    nn_ratio: jnp.ndarray = 0.8,
):
    """Track-local-map search (reference SearchByProjection(Frame,
    vector<MapPoint*>), src/ORBmatcher.cc:19-65): project local map points
    (frustum-checked upstream), window r*scale^predLevel, levels
    [predLevel-1, predLevel], TH_HIGH, ratio best<0.8*second applied when
    best and second sit on the same level band, skip keypoints that already
    carry a map point.

    Returns MatchResult over the map points.
    """
    D = distance_matrix(desc_mp, desc2)
    dx = jnp.abs(xy2[None, :, 0] - proj_xy[:, None, 0])
    dy = jnp.abs(xy2[None, :, 1] - proj_xy[:, None, 1])
    in_window = (dx <= radius[:, None]) & (dy <= radius[:, None])
    lev_ok = (oct2[None, :] >= pred_level[:, None] - 1) & (
        oct2[None, :] <= pred_level[:, None]
    )
    mask = (
        pt_valid[:, None] & valid2[None, :] & in_window & lev_ok
        & ~already_matched2[None, :]
    )
    best_j, best_d, second_d = _masked_best2(D, mask)
    # Reference applies the ratio only if bestLevel == bestLevel2; dense
    # equivalent: compute second-best level via one more masked pass.
    cols = jnp.arange(xy2.shape[0])[None, :]
    Dm = jnp.where(mask, D, _BIG)
    Dm2 = jnp.where(cols == best_j[:, None], _BIG, Dm)
    second_j = jnp.argmin(Dm2, axis=1)
    same_level = oct2[best_j] == oct2[second_j]
    ratio_ok = jnp.where(
        same_level & (second_d < _BIG),
        best_d.astype(jnp.float32) < nn_ratio * second_d.astype(jnp.float32),
        True,
    )
    matched = (best_d <= TH_HIGH) & ratio_ok & pt_valid
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[0])
    return MatchResult(jnp.where(matched, best_j, -1), best_d)


@jax.jit
def search_for_triangulation(
    xy1, desc1, avail1, oct1, ang1,
    xy2, desc2, avail2, oct2, ang2,
    F12, inv_sigma2_levels, epipole_xy, check_epipole_dist,
):
    """Epipolar search for new map points between two keyframes (reference
    SearchForTriangulation, src/ORBmatcher.cc:368-467). The reference
    restricts candidates to shared BoW nodes for speed; the dense program
    evaluates the full masked matrix (1 matmul) and applies the same
    acceptance tests: features without existing map points, TH_LOW,
    epipolar-line distance < 3.84 sigma^2 (CheckDistEpipolarLine), distance
    from the epipole > threshold, rotation histogram.

    F12 maps kp1 -> epipolar line in image 2: l2 = F12^T x1 (x in pixel
    homogeneous coords). Returns MatchResult over set 1.
    """
    D = distance_matrix(desc1, desc2)
    ones = jnp.ones((xy1.shape[0], 1), xy1.dtype)
    x1h = jnp.concatenate([xy1, ones], axis=1)            # [N1,3]
    lines2 = x1h @ F12                                     # [N1,3] (a,b,c)
    a, b, c = lines2[:, 0:1], lines2[:, 1:2], lines2[:, 2:3]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c
    den = a * a + b * b
    dist2 = (num * num) / jnp.maximum(den, 1e-12)
    sigma2_2 = (1.0 / inv_sigma2_levels)[oct2]             # sigma^2 per kp2
    epi_ok = dist2 < 3.84 * sigma2_2[None, :]
    # Reject kp2 too close to the epipole (reference :427-434; guards
    # degenerate near-epipole geometry for small baselines).
    de = jnp.sum((xy2 - epipole_xy[None, :]) ** 2, axis=1)
    scale2 = sigma2_2  # scale^2 of kp2's level
    far_from_epipole = jnp.where(check_epipole_dist, de >= 100.0 * scale2, True)
    mask = (
        avail1[:, None] & avail2[None, :]
        & epi_ok & far_from_epipole[None, :]
    )
    best_j, best_d, _ = _masked_best2(D, mask)
    matched = (best_d <= TH_LOW) & avail1
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[0])
    matched = rotation_consistency(ang1, ang2[best_j], matched)
    return MatchResult(jnp.where(matched, best_j, -1), best_d)


@jax.jit
def search_by_projection_set(
    proj_xy, radius, pred_level, pt_valid, desc_mp,
    xy2, desc2, valid2, oct2, already_found2,
    max_dist: jnp.ndarray = 100,
):
    """Projection search against a keypoint set with per-point predicted
    level band [l-1, l+1] and an exclusion set — used by relocalization
    top-up (reference SearchByProjection(Frame, KeyFrame, set), :820-894)
    and loop-closing projection (SearchByProjection(KeyFrame, Scw, ...),
    :121-195; there with TH_LOW and no exclusions).

    Returns MatchResult over the map points.
    """
    D = distance_matrix(desc_mp, desc2)
    dx = jnp.abs(xy2[None, :, 0] - proj_xy[:, None, 0])
    dy = jnp.abs(xy2[None, :, 1] - proj_xy[:, None, 1])
    in_window = (dx <= radius[:, None]) & (dy <= radius[:, None])
    lev_ok = (oct2[None, :] >= pred_level[:, None] - 1) & (
        oct2[None, :] <= pred_level[:, None] + 1
    )
    mask = (
        pt_valid[:, None] & valid2[None, :] & in_window & lev_ok
        & ~already_found2[None, :]
    )
    best_j, best_d, _ = _masked_best2(D, mask)
    matched = (best_d <= max_dist) & pt_valid
    matched = _dedupe_keep_best(best_j, best_d, matched, xy2.shape[0])
    return MatchResult(jnp.where(matched, best_j, -1), best_d)


@jax.jit
def search_by_node_id(
    desc1, valid1, ang1, node1,
    desc2, valid2, ang2, node2,
    nn_ratio: jnp.ndarray = 0.7,
    max_dist: jnp.ndarray = TH_LOW,
    use_rotation: bool = True,
):
    """BoW-node constrained matching (reference SearchByBoW both variants,
    src/ORBmatcher.cc:88-119 [stubbed in the fork; implemented here with
    upstream-complete semantics] and :278-366): candidates restricted to
    descriptors under the same vocabulary node, ratio test, TH_LOW,
    one-to-one, rotation histogram.

    node*: i32[N] vocabulary node id at the direct-index level (-1 = none).
    Returns MatchResult over set 1.
    """
    D = distance_matrix(desc1, desc2)
    mask = (
        valid1[:, None] & valid2[None, :]
        & (node1[:, None] >= 0)
        & (node1[:, None] == node2[None, :])
    )
    best_j, best_d, second_d = _masked_best2(D, mask)
    matched = (
        (best_d <= max_dist)
        & (best_d.astype(jnp.float32) < nn_ratio * second_d.astype(jnp.float32))
        & valid1
    )
    matched = _dedupe_keep_best(best_j, best_d, matched, desc2.shape[0])
    if use_rotation:
        matched = rotation_consistency(ang1, ang2[best_j], matched)
    return MatchResult(jnp.where(matched, best_j, -1), best_d)


@jax.jit
def search_by_node_id_batch(
    desc1, valid1, ang1, node1,
    desc2, valid2, ang2, node2,
    nn_ratio: jnp.ndarray = 0.7,
):
    """search_by_node_id vmapped over C candidate keyframes in ONE device
    program (set-1 args carry a leading [C] axis; the current frame's set-2
    args broadcast). Used by relocalization, where the reference runs
    SearchByBoW once per BoW candidate (src/Tracking.cc:820-860) — batching
    removes both the per-candidate round trips and any need to cap the
    candidate list. Returns idx2 i32[C, N1]."""
    res = jax.vmap(
        lambda d1, v1, a1, n1: search_by_node_id(
            d1, v1, a1, n1, desc2, valid2, ang2, node2, nn_ratio=nn_ratio)
    )(desc1, valid1, ang1, node1)
    return res.idx2


@jax.jit
def search_by_node_id_retry_batch(
    desc1, valid1, ang1, node1,
    desc2, valid2, ang2, node2,
    nn_ratio: jnp.ndarray = 0.75,
    min_matches: jnp.ndarray = 20,
):
    """SearchByBoW(KF,KF) over C candidate keyframes in ONE device program
    (set-2 args carry a leading [C] axis; set-1 broadcasts), with the
    unconstrained retry IN-PROGRAM: when the node-constrained pass yields
    fewer than min_matches, that candidate's result falls back to dense
    unconstrained matching (the node constraint exists in the reference
    for SPEED, src/ORBmatcher.cc:278-366; our matching is one matmul
    either way, and a shallow self-trained vocabulary under-populates
    nodes). The loop closer used to pay 1-2 device round trips PER
    candidate here. Returns idx2 i32[C, N1]."""
    zero1 = jnp.zeros_like(node1)

    def one(d2, v2, a2, n2):
        rc = search_by_node_id(desc1, valid1, ang1, node1,
                               d2, v2, a2, n2, nn_ratio=nn_ratio)
        ru = search_by_node_id(desc1, valid1, ang1, zero1,
                               d2, v2, a2, jnp.zeros_like(n2),
                               nn_ratio=nn_ratio)
        enough = jnp.sum((rc.idx2 >= 0).astype(jnp.int32)) >= min_matches
        return jnp.where(enough, rc.idx2, ru.idx2)

    return jax.vmap(one)(desc2, valid2, ang2, node2)


def _best_in_window(D, proj, rad, lvl, ok, xy, valid, octv):
    """Best column per row under the Sim3 projection window: column j is a
    candidate for row i iff |xy_j - proj_i| <= rad_i (both axes) and
    oct_j in [lvl_i - 1, lvl_i]. Returns (best_j, found bool[N])."""
    dx = jnp.abs(xy[None, :, 0] - proj[:, None, 0])
    dy = jnp.abs(xy[None, :, 1] - proj[:, None, 1])
    in_window = (dx <= rad[:, None]) & (dy <= rad[:, None])
    lev_ok = (octv[None, :] >= lvl[:, None] - 1) & (octv[None, :] <= lvl[:, None])
    mask = ok[:, None] & valid[None, :] & in_window & lev_ok
    best_j, best_d, _ = _masked_best2(D, mask)
    return best_j, (best_d <= TH_HIGH) & ok


@jax.jit
def search_by_sim3(
    desc_mp1, proj_1in2, rad1, lvl1, ok1,
    desc_mp2, proj_2in1, rad2, lvl2, ok2,
    desc1, xy1, valid1, oct1,
    desc2, xy2, valid2, oct2,
):
    """Mutual Sim3-guided re-search between two keyframes (upstream
    ORBmatcher::SearchBySim3; the reference fork's copy at
    src/ORBmatcher.cc:636-730 is one-directional and drops pre-existing
    matches — implemented upstream-complete here per SURVEY.md §0.1).

    Each KF's map points (aligned to feature slots; desc_mp* are the
    distinctive map-point descriptors) are projected into the OTHER
    keyframe with the candidate Sim3; the best Hamming match is taken
    inside the per-point radius window and octave band [lvl-1, lvl]
    (TH_HIGH gate, no ratio test), and only MUTUAL best pairs survive:
    vnMatch2[vnMatch1[i1]] == i1.

    Geometry (projections, radii, predicted levels, in-front/in-image/
    scale-invariance validity -> ok*) is precomputed by the caller; this
    kernel is two masked distance programs + the agreement check.

    Returns idx2 i32[N1]: feature slot in KF2 mutually matched to KF1 slot
    i1 (-1 if none).
    """
    D12 = distance_matrix(desc_mp1, desc2)     # [N1, N2]
    D21 = distance_matrix(desc_mp2, desc1)     # [N2, N1]
    match1, found1 = _best_in_window(
        D12, proj_1in2, rad1, lvl1, ok1, xy2, valid2, oct2)
    match2, found2 = _best_in_window(
        D21, proj_2in1, rad2, lvl2, ok2, xy1, valid1, oct1)
    # Mutual agreement.
    back = jnp.where(found2[match1], match2[match1], -1)
    mutual = found1 & (back == jnp.arange(match1.shape[0]))
    return jnp.where(mutual, match1, -1)


@jax.jit
def search_for_triangulation_batch(
    xy1, desc1, avail1, oct1, ang1,
    xy2, desc2, avail2, oct2, ang2,
    F12, inv_sigma2_levels, epipole_xy, nb_valid,
):
    """search_for_triangulation vmapped over M neighbor keyframes in ONE
    device program (kf2 args have a leading [M] axis; kf1 args broadcast).
    Per-neighbor calls each cost a host round trip — batching the ~20
    covisible neighbors of a new keyframe turns 20 round trips into 1. nb_valid masks padded neighbor slots. Returns idx2 i32[M, N1].
    """
    res = jax.vmap(
        lambda b_xy2, b_desc2, b_avail2, b_oct2, b_ang2, b_F12, b_epi:
        search_for_triangulation(
            xy1, desc1, avail1, oct1, ang1,
            b_xy2, b_desc2, b_avail2, b_oct2, b_ang2,
            b_F12, inv_sigma2_levels, b_epi, True)
    )(xy2, desc2, avail2, oct2, ang2, F12, epipole_xy)
    return jnp.where(nb_valid[:, None], res.idx2, -1)


@jax.jit
def search_by_projection_set_batch(
    proj_xy, radius, pred_level, pt_valid, desc_mp,
    xy2, desc2, valid2, oct2, already_found2,
    max_dist: jnp.ndarray = TH_LOW,
):
    """search_by_projection_set vmapped over M target keyframes in ONE
    device program (all args carry a leading [M] axis except max_dist).
    Used by map-point fusion, where the reference's ORBmatcher::Fuse
    (src/ORBmatcher.cc:504-568) runs once per (source, target) pair — each
    per-pair device call would cost a host round trip.

    Returns idx2 i32[M, P]: best feature slot per (target, point).
    """
    res = jax.vmap(
        lambda p, r, l, v, d, x2, d2, v2, o2, a2: search_by_projection_set(
            p, r, l, v, d, x2, d2, v2, o2, a2, max_dist=max_dist)
    )(proj_xy, radius, pred_level, pt_valid, desc_mp,
      xy2, desc2, valid2, oct2, already_found2)
    return res.idx2
