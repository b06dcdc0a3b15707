"""Rotated BRIEF (rBRIEF) 256-bit descriptors.

Replaces reference computeOrbDescriptor (src/ORBextractor.cc:57-73) + the
256-pair sampling pattern (:75-113).

Design notes:
  * The sampling pattern is the STANDARD published ORB table (see
    ops/brief_pattern.py for provenance: recovered empirically from OpenCV
    behavior, not copied; the reference fork's own copy of the table is
    truncated/corrupted — a §0.1-class fork bug). Using the standard table
    makes descriptors bit-compatible with OpenCV ORB and with the stock
    ORBvoc.txt vocabulary, which was trained on those descriptors.
    Bit/byte layout also matches: bit i of little-endian byte j = test
    8*j + i, so packed uint32[8] words viewed as uint8[32] equal OpenCV
    descriptor rows.
  * Rotation: test offsets are rotated by the keypoint angle with the same
    round-to-integer semantics as the reference's GET_VALUE macro, i.e.
    x' = round(x cos - y sin), y' = round(x sin + y cos).
  * The 256 tests of a keypoint are one contraction of its blurred patch
    [P*P] with its angle bin's +/-1 test matrix; the sign test and bit
    packing are dense elementwise ops producing uint32[B,N,8].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

N_BITS = 256
PATCH_RADIUS = 18     # gathered patch radius; max rotated |offset| = round(hypot(13,13)) = 18


def make_pattern() -> np.ndarray:
    """The standard ORB BRIEF pattern: int32[256, 4] rows (x1, y1, x2, y2).

    Max test-point norm is hypot(13,13) = 18.38, so every rotation-rounded
    offset stays within PATCH_RADIUS=18 (asserted when building the binned
    test matrices)."""
    from orb_slam_system_tpu.ops.brief_pattern import ORB_PATTERN

    return ORB_PATTERN


_PATTERN = make_pattern()

# Angle quantization for the matmul descriptor path: 32 bins (11.25 deg). The
# rotated test offsets are integer-rounded anyway (sub-pixel precision is
# already quantized); bin-center rotation changes offsets by < 1px for the
# typical |offset| ~ 6px, on par with the rounding the reference applies.
N_ANGLE_BINS = 32


def _binned_test_matrices():
    """Static per-bin one-hot difference matrices E[a] in {-1,0,+1} of shape
    [P*P, 256] with descriptor bit b of a keypoint in bin a given by
    (patch_flat @ E[a])[b] > 0  (i.e. I[p2] - I[p1] > 0  <=>  t1 < t2)."""
    P = 2 * PATCH_RADIUS + 1
    E = np.zeros((N_ANGLE_BINS, P * P, N_BITS), np.float32)
    pat = _PATTERN.astype(np.float64)
    for a in range(N_ANGLE_BINS):
        th = 2 * np.pi * a / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for b in range(N_BITS):
            x1, y1, x2, y2 = pat[b]
            xr1 = int(round(x1 * ca - y1 * sa)) + PATCH_RADIUS
            yr1 = int(round(x1 * sa + y1 * ca)) + PATCH_RADIUS
            xr2 = int(round(x2 * ca - y2 * sa)) + PATCH_RADIUS
            yr2 = int(round(x2 * sa + y2 * ca)) + PATCH_RADIUS
            assert 0 <= min(xr1, yr1, xr2, yr2) and max(xr1, yr1, xr2, yr2) < P
            E[a, yr1 * P + xr1, b] -= 1.0
            E[a, yr2 * P + xr2, b] += 1.0
    return E


# Stored pre-cast to bfloat16 so the jitted constant needs no compile-time
# f32 transpose/convert pass (XLA constant-folding of the [32,1369,256]
# tensor cost ~4s per compile otherwise).
import ml_dtypes  # ships with jax

_E_BINNED = _binned_test_matrices().astype(ml_dtypes.bfloat16)


def _angle_bins(angles: jnp.ndarray) -> jnp.ndarray:
    bin_f = angles * (N_ANGLE_BINS / (2 * jnp.pi))
    return jnp.round(bin_f).astype(jnp.int32) % N_ANGLE_BINS


def compute_descriptors_dense(patches: jnp.ndarray,
                              angles: jnp.ndarray) -> jnp.ndarray:
    """Reference formulation (all angle bins computed, one selected):
    kept as the oracle for equality tests and small problem sizes.

    patches: f32[B,N,P,P] from the *blurred* level image, P=2*18+1=37;
    angles: f32[B,N] radians. Returns uint32[B,N,8] packed descriptors."""
    B, N, P, _ = patches.shape
    assert P == 2 * PATCH_RADIUS + 1
    bins = _angle_bins(angles)                                 # [B,N]
    flat = patches.reshape(B, N, P * P).astype(jnp.bfloat16)
    E = jnp.asarray(_E_BINNED, jnp.bfloat16)                   # [A,PP,256]
    # diffs[a, b*n, bit] = patch . E[a]  -> select per-keypoint bin.
    diffs = jnp.einsum("bnp,apc->banc", flat, E,
                       precision=jax.lax.Precision.DEFAULT,
                       preferred_element_type=jnp.float32)     # [B,A,N,256]
    sel = jnp.take_along_axis(
        diffs, bins[:, None, :, None].astype(jnp.int32), axis=1)[:, 0]
    bits = (sel > 0).astype(jnp.uint32)                        # [B,N,256]
    return pack_bits(bits)


# Chunk size for the binned-sort descriptor path: keypoints sorted by angle
# bin are processed in single-bin chunks of CHUNK rows, so each chunk
# contracts against ONE [P*P, 256] test matrix instead of all 32 (the dense
# einsum above computes 32x the needed FLOPs).
CHUNK = 128

PP = (2 * PATCH_RADIUS + 1) ** 2             # 1369
PP_PAD = -(-PP // 128) * 128                 # 1408: 128-aligned contraction


@functools.lru_cache(maxsize=1)
def _e_padded() -> np.ndarray:
    """[A, PP_PAD, 256] bf16 test matrices, zero rows in the padding."""
    e = np.zeros((N_ANGLE_BINS, PP_PAD, N_BITS), dtype=_E_BINNED.dtype)
    e[:, :PP] = _E_BINNED
    return e


def _chunk_layout(bins_flat: jnp.ndarray, n_chunks: int):
    """Assign each keypoint a slot in a padded, bin-sorted layout where
    every CHUNK-row chunk holds keypoints of a single angle bin.

    bins_flat: i32[M]. Returns (padded_idx i32[n_chunks*CHUNK] with M as
    the dummy row id, chunk_bin i32[n_chunks], slot_of i32[M])."""
    M = bins_flat.shape[0]
    # Rank-within-bin via one-hot prefix sum: no argsort needed. The
    # [M, A] cumsum runs as a two-level scan (within 512-row groups +
    # group offsets) instead of one M-long scan.
    oh = (bins_flat[:, None]
          == jnp.arange(N_ANGLE_BINS, dtype=jnp.int32)[None, :])
    ohi = oh.astype(jnp.int32)
    counts = jnp.sum(ohi, axis=0)                                # [A]
    GRP = 512
    if M % GRP == 0 and M > GRP:
        g = ohi.reshape(M // GRP, GRP, N_ANGLE_BINS)
        inner = jnp.cumsum(g, axis=1)                            # [G,512,A]
        offs = jnp.cumsum(inner[:, -1, :], axis=0)               # [G,A]
        offs = jnp.concatenate(
            [jnp.zeros((1, N_ANGLE_BINS), jnp.int32), offs[:-1]], axis=0)
        csum = (inner + offs[:, None, :]).reshape(M, N_ANGLE_BINS)
    else:
        csum = jnp.cumsum(ohi, axis=0)
    rank_in_bin = jnp.take_along_axis(
        csum, bins_flat[:, None], axis=1)[:, 0] - 1
    chunks_per_bin = (counts + CHUNK - 1) // CHUNK
    chunk_start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(chunks_per_bin)])   # [A+1]
    slot = chunk_start[bins_flat] * CHUNK + rank_in_bin          # [M]
    padded_idx = jnp.full((n_chunks * CHUNK,), M, jnp.int32).at[slot].set(
        jnp.arange(M, dtype=jnp.int32))
    k = jnp.arange(n_chunks, dtype=jnp.int32)
    chunk_bin = jnp.clip(
        jnp.searchsorted(chunk_start[1:], k, side="right"),
        0, N_ANGLE_BINS - 1).astype(jnp.int32)
    return padded_idx, chunk_bin, slot


def compute_descriptors(patches: jnp.ndarray, angles: jnp.ndarray) -> jnp.ndarray:
    """patches: f32[B,N,P,P] from the *blurred* level image, P=2*18+1=37;
    angles: f32[B,N] radians. Returns uint32[B,N,8] packed descriptors.

    Matmul formulation: instead of 512 rotated scalar gathers per
    keypoint, keypoints are sorted by angle bin and processed in
    single-bin chunks, each one a [CHUNK, P*P] @ [P*P, 256] bf16 matmul
    (f32 accumulation) against that bin's static +/-1 test matrix.
    Bit-identical to compute_descriptors_dense: same per-keypoint
    contraction, just without materializing the 31 unused bins."""
    B, N, P, _ = patches.shape
    assert P == 2 * PATCH_RADIUS + 1
    M = B * N
    # Worst-case chunk count: full occupancy + one partial chunk per bin.
    n_chunks = -(-M // CHUNK) + N_ANGLE_BINS
    bins = _angle_bins(angles).reshape(M)
    padded_idx, chunk_bin, slot_of = _chunk_layout(bins, n_chunks)
    # Row width padded to the 128-aligned 1408 BEFORE the bin-sort row
    # gather (the padding columns are zero and the test matrices carry
    # zero rows there, so the contraction is unchanged): the gather then
    # moves 128-multiple rows and the matmul sees an aligned depth.
    flat = patches.reshape(M, P * P).astype(jnp.bfloat16)
    flat = jnp.pad(flat, ((0, 1), (0, PP_PAD - P * P)))
    p_sorted = flat[padded_idx]                 # [S, PP_PAD] row gather
    E = jnp.asarray(_e_padded())                # [A, PP_PAD, 256] bf16
    diffs = jnp.einsum(
        "kcp,kpq->kcq",
        p_sorted.reshape(n_chunks, CHUNK, PP_PAD),
        E[chunk_bin],
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32).reshape(-1, N_BITS)
    # Pack BEFORE unsorting: the bit-pack commutes with the row
    # permutation, so the unsort gather moves [M,8] u32 words instead of
    # [M,256] bit columns (32x less data through the gather).
    bits_sorted = (diffs > 0).astype(jnp.uint32)               # [S,256]
    packed_sorted = pack_bits(bits_sorted)                     # [S,8]
    return packed_sorted[slot_of].reshape(B, N, 8)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """bits: uint32[..., 256] of 0/1 -> packed uint32[..., 8], bit i of word w
    = test index w*32 + i."""
    *lead, nb = bits.shape
    assert nb == N_BITS
    grouped = bits.reshape(*lead, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(grouped << shifts, axis=-1).astype(jnp.uint32)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """packed uint32[..., 8] -> bits uint32[..., 256]."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*desc.shape[:-1], N_BITS)
