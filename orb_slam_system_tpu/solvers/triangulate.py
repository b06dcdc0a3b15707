"""Batched DLT triangulation.

Replaces reference Initializer::Triangulate (src/Initializer.cc:654) and the
per-pair triangulation in LocalMapping::CreateNewMapPoints (upstream
semantics; the fork stubbed it, SURVEY.md §0.1 row 2).

Design: the 4x4 DLT system per correspondence is solved for all N
correspondences at once via a batched symmetric eigendecomposition of A^T A
(smallest eigenvector == smallest right singular vector of A), which XLA
batches cleanly — no per-point SVD loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp



@jax.jit
def triangulate_dlt(uv1, uv2, P1, P2):
    """uv1, uv2: f32[N,2] pixel coords in images 1/2; P1, P2: f32[3,4]
    projection matrices. Returns X f32[N,3] (homogeneous-normalized) and
    w_ok bool[N] (nondegenerate homogeneous scale)."""
    x1, y1 = uv1[:, 0], uv1[:, 1]
    x2, y2 = uv2[:, 0], uv2[:, 1]
    A = jnp.stack(
        [
            x1[:, None] * P1[2] - P1[0],
            y1[:, None] * P1[2] - P1[1],
            x2[:, None] * P2[2] - P2[0],
            y2[:, None] * P2[2] - P2[1],
        ],
        axis=1,
    )  # [N,4,4]
    AtA = jnp.einsum("nij,nik->njk", A, A)
    _, vecs = jnp.linalg.eigh(AtA)           # ascending eigenvalues
    Xh = vecs[:, :, 0]                        # [N,4] smallest eigenvector
    w = Xh[:, 3]
    w_ok = jnp.abs(w) > 1e-9
    ws = jnp.where(w_ok, w, 1.0)
    return Xh[:, :3] / ws[:, None], w_ok
