"""ORB feature extraction pipeline: pyramid -> FAST -> orientation -> rBRIEF.

Replaces reference ORBextractor::operator() (src/ORBextractor.cc:442-495) as a
single jitted device program over batched frames. All shapes are static:
per-level keypoint budgets come from the config (geometric split, matching
src/ORBextractor.cc:141-151), each padded slot carries a validity bit.

Output keypoint coordinates are in level-0 pixels (the reference multiplies
kp.pt by the level scale at the end of operator(), :486-494); `octave` and
per-octave sigma2 follow the reference's scale pyramid semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam_system_tpu.config import ORBConfig
from orb_slam_system_tpu.ops import fast as fast_ops
from orb_slam_system_tpu.ops import pyramid as pyr_ops
from orb_slam_system_tpu.ops.brief import PATCH_RADIUS, compute_descriptors
from orb_slam_system_tpu.ops.orientation import HALF_PATCH, ic_angles
from orb_slam_system_tpu.ops.patches import gather_patches

EDGE_MARGIN = 19  # reference EDGE_THRESHOLD (src/ORBextractor.cc:18)


def _blur_patches(patches: jnp.ndarray) -> jnp.ndarray:
    """Valid-mode separable 7x7 sigma=2 Gaussian over [B,N,P,P] patches
    (the reference blurs whole pyramid levels before computing descriptors,
    src/ORBextractor.cc:472-494; blurring only the gathered patches is
    equivalent inside the valid region and far cheaper)."""
    k = jnp.asarray(pyr_ops.gaussian_kernel_1d(7, 2.0))
    x = patches
    out = None
    for i in range(7):
        sl = jax.lax.slice_in_dim(x, i, i + x.shape[2] - 6, axis=2)
        out = sl * k[i] if out is None else out + sl * k[i]
    x = out
    out = None
    for i in range(7):
        sl = jax.lax.slice_in_dim(x, i, i + x.shape[3] - 6, axis=3)
        out = sl * k[i] if out is None else out + sl * k[i]
    return out


class FeatureSet(NamedTuple):
    """Batched, padded keypoint set (level-0 coordinates)."""

    xy: jnp.ndarray        # f32[B, N, 2] (x, y) in level-0 pixels
    response: jnp.ndarray  # f32[B, N]
    angle: jnp.ndarray     # f32[B, N] radians in [0, 2pi)
    octave: jnp.ndarray    # i32[B, N]
    desc: jnp.ndarray      # u32[B, N, 8]
    valid: jnp.ndarray     # bool[B, N]

    @property
    def n_slots(self) -> int:
        return self.xy.shape[1]


class ORBExtractor:
    """Config-bound, shape-specialized ORB extractor.

    One instance per (image size, feature budget); the jitted program is
    cached after first trace. Mirrors the reference's use of separate
    ORBextractor instances for tracking vs. monocular init (2x features,
    src/Tracking.cc:76-82).
    """

    def __init__(self, cfg: ORBConfig, height: int, width: int,
                 pad_total: int | None = None, cell: int = 16):
        self.cfg = cfg
        self.height = height
        self.width = width
        budgets = cfg.per_level_features()
        total = sum(budgets)
        if pad_total is None:
            pad_total = ((total + 127) // 128) * 128
        budgets[0] += pad_total - total  # pad slack goes to level 0
        self.budgets = budgets
        self.n_slots = pad_total
        self.scales = np.asarray(cfg.level_scales(), dtype=np.float32)
        self.sigma2 = (self.scales ** 2).astype(np.float32)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self.cell = cell
        # All-level gather canvas geometry: each reflect-padded level is
        # stacked at an 8-aligned row offset so ONE gather extracts every
        # level's patches (see _extract).
        shapes = pyr_ops.level_shapes(height, width, cfg.n_levels,
                                      cfg.scale_factor)
        offs, rows = [], 0
        for (h, _w) in shapes:
            offs.append(rows)
            rows += -(-(h + 6) // 8) * 8
        self._canvas_offs = offs
        self._canvas_rows = rows
        self._canvas_cols = width + 6
        self._fn = jax.jit(self._extract)

    def __call__(self, img: jnp.ndarray) -> FeatureSet:
        """img: f32[B, H, W] grayscale in [0, 255]."""
        return self._fn(img)

    def _extract(self, img: jnp.ndarray) -> FeatureSet:
        cfg = self.cfg
        levels = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        B = img.shape[0]
        R_G = PATCH_RADIUS + 3
        xs, resps, valids, octs, xy_gather = [], [], [], [], []
        active = [l for l in range(len(levels)) if self.budgets[l] > 0]
        # ALL levels' keypoint selection inside the one extraction program.
        selections = fast_ops.select_keypoints_multi(
            [fast_ops.fast_score_map(levels[l], border=EDGE_MARGIN)
             for l in active],
            [self.budgets[l] for l in active],
            ini_th=float(cfg.ini_th_fast),
            min_th=float(cfg.min_th_fast),
            cell=self.cell,
        )
        for l, (xy_l, resp, valid) in zip(active, selections):
            # Per-level gather coordinates in the all-level canvas (below):
            # +3 for the reflect-pad blur halo, + the level's row offset.
            xy_gather.append(xy_l + jnp.asarray([3, 3 + self._canvas_offs[l]],
                                                jnp.int32))
            xs.append(xy_l.astype(jnp.float32) * self.scales[l])
            resps.append(resp)
            valids.append(valid)
            octs.append(jnp.full(resp.shape, l, jnp.int32))
        # ONE patch gather for ALL levels: the reflect-padded levels are
        # stacked into a single canvas (8-aligned row offsets) so a single
        # gather extracts every 43x43 patch (radius 21 = descriptor radius
        # 18 + blur halo 3). The patch serves both the IC-angle moments
        # (center 31x31) and, after the in-patch separable 7x7 blur, the
        # rBRIEF window, replacing two gathers and an image-wide blur.
        canvas = jnp.zeros((B, self._canvas_rows, self._canvas_cols),
                           img.dtype)
        for l, lvl in enumerate(levels):
            padded = jnp.pad(lvl, ((0, 0), (3, 3), (3, 3)), mode="reflect")
            canvas = jax.lax.dynamic_update_slice(
                canvas, padded, (0, self._canvas_offs[l], 0))
        xy_all = jnp.concatenate(xy_gather, axis=1)        # [B, N_all, 2]
        patches_g = gather_patches(canvas, xy_all, R_G)    # [B,N_all,P,P]
        c0 = (PATCH_RADIUS + 3) - HALF_PATCH
        patches_o = patches_g[:, :, c0:c0 + 2 * HALF_PATCH + 1,
                              c0:c0 + 2 * HALF_PATCH + 1]
        ang = ic_angles(patches_o)
        patches_d = _blur_patches(patches_g)
        desc = compute_descriptors(patches_d, ang)
        return FeatureSet(
            xy=jnp.concatenate(xs, axis=1),
            response=jnp.concatenate(resps, axis=1),
            angle=ang,
            octave=jnp.concatenate(octs, axis=1),
            desc=desc,
            valid=jnp.concatenate(valids, axis=1),
        )
