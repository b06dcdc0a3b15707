"""IC-angle keypoint orientation (intensity centroid).

Replaces reference IC_Angle (src/ORBextractor.cc:21-48): moments m01/m10 over
a circular patch of radius 15 (HALF_PATCH_SIZE, src/ORBextractor.cc:17) whose
per-row extent is the umax table built in the ctor (:155-169).

Design: the circular mask times coordinate grids become two constant
[31,31] weight matrices; the angle for all keypoints is two batched weighted
sums over gathered patches, no per-keypoint loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH = 15  # reference src/ORBextractor.cc:17


def _umax_table(half_patch: int = HALF_PATCH) -> np.ndarray:
    """Per-row half-width of the circular patch, built the same way as the
    reference ctor (src/ORBextractor.cc:155-169): lower quarter by rounding
    sqrt(r^2 - v^2), upper quarter mirrored to keep the circle symmetric."""
    umax = np.zeros(half_patch + 1, dtype=np.int32)
    vmax = int(np.floor(half_patch * np.sqrt(2.0) / 2.0 + 1))
    vmin = int(np.ceil(half_patch * np.sqrt(2.0) / 2.0))
    hp2 = half_patch * half_patch
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def moment_weights(half_patch: int = HALF_PATCH):
    """Constant weight matrices WX, WY (f32[P,P]) with P=2*half_patch+1 such
    that m10 = sum(patch * WX), m01 = sum(patch * WY) over the circular mask."""
    umax = _umax_table(half_patch)
    P = 2 * half_patch + 1
    wx = np.zeros((P, P), dtype=np.float32)
    wy = np.zeros((P, P), dtype=np.float32)
    for dy in range(-half_patch, half_patch + 1):
        for dx in range(-half_patch, half_patch + 1):
            if abs(dx) <= int(umax[abs(dy)]):
                wx[dy + half_patch, dx + half_patch] = dx
                wy[dy + half_patch, dx + half_patch] = dy
    return wx, wy


_WX, _WY = moment_weights()


def angles_from_moments(m: jnp.ndarray) -> jnp.ndarray:
    """m: f32[..., 2] = (m10, m01) -> angle radians in [0, 2pi)."""
    ang = jnp.arctan2(m[..., 1], m[..., 0])
    return jnp.where(ang < 0, ang + 2.0 * jnp.pi, ang)


def ic_angles(patches: jnp.ndarray) -> jnp.ndarray:
    """patches: f32[B,N,31,31] (unblurred level image) -> angle radians
    f32[B,N] in [0, 2pi) measured like OpenCV's fastAtan2 result (degrees
    there; radians here, converted where needed).

    The two masked moment sums run as one [B*N, P*P] @ [P*P, 2] matmul
    instead of broadcast-multiply reductions."""
    B, N, P, _ = patches.shape
    Wm = jnp.asarray(np.stack([_WX.reshape(-1), _WY.reshape(-1)], axis=1))
    # HIGHEST precision: the moments are a cancellation-heavy +-15-weighted
    # sum; reduced-precision (TF32/bf16) input rounding shifts angles
    # materially on low-texture patches.
    m = jnp.einsum("bnp,pk->bnk", patches.reshape(B, N, P * P), Wm,
                   precision=jax.lax.Precision.HIGHEST)   # [B,N,2]
    ang = jnp.arctan2(m[..., 1], m[..., 0])
    return jnp.where(ang < 0, ang + 2.0 * jnp.pi, ang)
