"""Rectified stereo matching + RGB-D pseudo-stereo.

Replaces reference Frame::ComputeStereoMatches (src/Frame.cc:446-620) and
ComputeStereoFromRGBD (:623-644).

Design: the reference's per-row candidate lists + per-keypoint sliding
SAD become (a) one masked Hamming distance matrix with row-band,
octave-band and disparity-range masks, and (b) a batched subpixel refinement
that gathers an 11x(11+2R) strip per matched keypoint and evaluates all 2R+1
SAD positions at once with a parabola fit — no scalar loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from orb_slam_system_tpu.ops.hamming import distance_matrix
from orb_slam_system_tpu.ops.matching import TH_HIGH, _BIG, _masked_best2

SAD_W = 5         # reference window w = 5 (patch 11x11)
SAD_L = 5         # sliding range +/-5 (reference L = 5)


def _gather_strip(img, x0, y0, h, w):
    """Gather [N, h, w] strips with top-left (y0, x0) (clamped)."""
    H, W = img.shape
    x0 = jnp.clip(x0, 0, W - w)
    y0 = jnp.clip(y0, 0, H - h)
    starts = jnp.stack([y0, x0], axis=-1).astype(jnp.int32)
    dnums = lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(0, 1))
    return lax.gather(img, starts, dimension_numbers=dnums,
                      slice_sizes=(h, w), mode=lax.GatherScatterMode.CLIP)


@functools.partial(jax.jit, static_argnames=("scale_factor",))
def stereo_match(
    imgL, imgR,
    xyL, octL, descL, validL,
    xyR, octR, descR, validR,
    scale_factors, bf, min_disp, max_disp,
    scale_factor: float = 1.2,
):
    """Returns (u_right f32[NL] (-1 if unmatched), depth f32[NL]).

    Masks (reference :446-530): right keypoint in row band |vL - vR| <=
    2*scale^octR, octave band [octL-1, octL+1], disparity in
    [min_disp, max_disp]; Hamming gate TH_HIGH; then SAD subpixel refinement
    on the keypoint's pyramid-level image (reference :527-575) with parabola
    interpolation and the reference's median-SAD outlier filter
    (1.5 * 1.4 * median).
    """
    NL = xyL.shape[0]
    D = distance_matrix(descL, descR)
    uL = xyL[:, 0]
    vL = xyL[:, 1]
    uR = xyR[:, 0]
    vR = xyR[:, 1]
    row_r = 2.0 * scale_factors[octR]                    # [NR]
    row_ok = jnp.abs(vL[:, None] - vR[None, :]) <= row_r[None, :]
    oct_ok = (octR[None, :] >= octL[:, None] - 1) & (
        octR[None, :] <= octL[:, None] + 1)
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp >= min_disp) & (disp <= max_disp)
    mask = validL[:, None] & validR[None, :] & row_ok & oct_ok & disp_ok
    best_j, best_d, _ = _masked_best2(D, mask)
    coarse = (best_d <= TH_HIGH) & validL
    u_r0 = uR[best_j]
    # ---- subpixel SAD refinement at the keypoint's PYRAMID LEVEL --------
    # (reference src/Frame.cc:527-575 refines on mvImagePyramid[kpL.octave]
    # with octave-scaled coordinates; refining on level 0 was a documented
    # r1 parity deviation — removed here. The per-level pyramids are cheap
    # matmul resizes, and XLA CSEs them with the extractor's when
    # traced in the same program.)
    w = SAD_W
    L = SAD_L
    n_levels = scale_factors.shape[0]
    # Reconstruct the two pyramids (same op as the extractor's).
    from orb_slam_system_tpu.ops.pyramid import build_pyramid

    pyrL = [p[0] for p in build_pyramid(imgL[None], int(n_levels),
                                        scale_factor)]
    pyrR = [p[0] for p in build_pyramid(imgR[None], int(n_levels),
                                        scale_factor)]
    inv_scale = 1.0 / scale_factors[octL]                 # [NL]
    uL_s = uL * inv_scale
    vL_s = vL * inv_scale
    uR_s = u_r0 * inv_scale
    sad = jnp.zeros((NL, 2 * L + 1), jnp.float32)
    for lv in range(int(n_levels)):
        on_lv = octL == lv
        xL0 = jnp.round(uL_s).astype(jnp.int32) - w
        yL0 = jnp.round(vL_s).astype(jnp.int32) - w
        patchL = _gather_strip(pyrL[lv], xL0, yL0, 2 * w + 1, 2 * w + 1)
        xR0 = jnp.round(uR_s).astype(jnp.int32) - w - L
        strip = _gather_strip(pyrR[lv], xR0, yL0,
                              2 * w + 1, 2 * w + 1 + 2 * L)
        centerL = patchL[:, w:w + 1, w:w + 1]
        pl_n = patchL - centerL          # reference normalizes by center
        sads = []
        for s in range(2 * L + 1):
            win = strip[:, :, s:s + 2 * w + 1]
            win = win - win[:, w:w + 1, w:w + 1]
            sads.append(jnp.sum(jnp.abs(pl_n - win), axis=(1, 2)))
        sad = jnp.where(on_lv[:, None], jnp.stack(sads, axis=1), sad)
    best_s = jnp.argmin(sad, axis=1)
    best_sad = jnp.min(sad, axis=1)
    interior = (best_s > 0) & (best_s < 2 * L)
    sm1 = sad[jnp.arange(NL), jnp.maximum(best_s - 1, 0)]
    sp1 = sad[jnp.arange(NL), jnp.minimum(best_s + 1, 2 * L)]
    s0 = best_sad
    denom = sm1 + sp1 - 2.0 * s0
    delta = jnp.where(jnp.abs(denom) > 1e-9,
                      (sm1 - sp1) / (2.0 * jnp.maximum(denom, 1e-9)), 0.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0) & interior
    # Back to level-0 pixel units (reference :570: bestuR = scale *
    # (scaleduR0 + bestincR + deltaR)).
    u_best = scale_factors[octL] * (
        uR_s + (best_s.astype(jnp.float32) - L) + delta)
    disparity = uL - u_best
    disp_fine_ok = (disparity >= jnp.maximum(min_disp, 1e-3)) & (
        disparity <= max_disp)
    matched = coarse & delta_ok & disp_fine_ok
    # Median-SAD outlier filter (reference :595-617).
    med = jnp.median(jnp.where(matched, best_sad, jnp.nan))
    med = jnp.nan_to_num(med, nan=1e9)
    sad_ok = best_sad <= 1.5 * 1.4 * med
    matched = matched & sad_ok
    depth = jnp.where(matched, bf / jnp.maximum(disparity, 1e-6), -1.0)
    u_right = jnp.where(matched, u_best, -1.0)
    return u_right, depth


@jax.jit
def rgbd_pseudo_stereo(depth_map, xy_raw, xy_und, valid, bf, depth_factor):
    """Reference ComputeStereoFromRGBD (src/Frame.cc:623-644): read depth at
    the RAW keypoint pixel, synthesize the right-view u from the UNDISTORTED
    x (matching the reference's kp vs kpU usage).

    depth_map: f32[H,W]. Returns (u_right f32[N], depth f32[N]); -1 invalid."""
    H, W = depth_map.shape
    xi = jnp.clip(jnp.round(xy_raw[:, 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(xy_raw[:, 1]).astype(jnp.int32), 0, H - 1)
    d = depth_map[yi, xi] * depth_factor
    ok = valid & (d > 0)
    u_r = jnp.where(ok, xy_und[:, 0] - bf / jnp.maximum(d, 1e-9), -1.0)
    return u_r, jnp.where(ok, d, -1.0)
