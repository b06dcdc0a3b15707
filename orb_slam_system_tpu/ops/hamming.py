"""256-bit Hamming distance kernels.

Replaces reference ORBmatcher::DescriptorDistance (src/ORBmatcher.cc:896-908,
SWAR popcount over 8 uint32 words) with two dense paths:

  * `distance_matrix` — the hot path: popcount-as-matmul.
    Descriptors are unpacked to +/-1 int8 vectors; for 256-bit strings,
    dot(a, b) = 256 - 2*hamming, so D = (256 - A @ B^T) / 2 runs as an int8
    matmul with int32 accumulation (exact; an integer tensor-core contraction
    on the GPU, so no float precision setting applies) (SURVEY.md §7.1).
  * `distance_pairwise` — SWAR popcount for elementwise pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from orb_slam_system_tpu.ops.brief import unpack_bits

N_BITS = 256


def to_pm1_int8(desc: jnp.ndarray) -> jnp.ndarray:
    """packed uint32[..., 8] -> int8[..., 256] in {-1, +1}."""
    bits = unpack_bits(desc)
    return (2 * bits.astype(jnp.int32) - 1).astype(jnp.int8)


def distance_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances via an int8 matmul.

    desc_a: uint32[N1, 8]; desc_b: uint32[N2, 8] -> int32[N1, N2].
    """
    a = to_pm1_int8(desc_a)
    b = to_pm1_int8(desc_b)
    dot = jax.lax.dot_general(
        a, b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (N_BITS - dot) // 2


def distance_matrix_from_pm1(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Same as distance_matrix but takes pre-unpacked +/-1 int8 [N,256]."""
    dot = jax.lax.dot_general(
        a, b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (N_BITS - dot) // 2


def popcount_u32(x: jnp.ndarray) -> jnp.ndarray:
    """SWAR popcount of uint32 (the same bit trick as the reference's
    DescriptorDistance, src/ORBmatcher.cc:896-908)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


def distance_pairwise(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance: uint32[..., 8] x uint32[..., 8] ->
    int32[...]."""
    x = jnp.bitwise_xor(desc_a, desc_b)
    return jnp.sum(popcount_u32(x), axis=-1).astype(jnp.int32)
