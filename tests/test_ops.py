import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam_system_tpu.config import ORBConfig
from orb_slam_system_tpu.dataio.synthetic import PlanarSceneRenderer, orbit_trajectory
from orb_slam_system_tpu.ops import fast as fast_ops
from orb_slam_system_tpu.ops import hamming
from orb_slam_system_tpu.ops.brief import make_pattern, pack_bits, unpack_bits
from orb_slam_system_tpu.ops.extractor import ORBExtractor
from orb_slam_system_tpu.ops.pyramid import build_pyramid, gaussian_blur, gaussian_kernel_1d


K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], dtype=np.float32)


@pytest.fixture(scope="module")
def frame():
    r = PlanarSceneRenderer(K, 160, 120)
    return r.render(orbit_trajectory(2)[0])


def test_pyramid_shapes():
    img = jnp.zeros((1, 120, 160))
    lv = build_pyramid(img, 4, 1.2)
    assert [x.shape for x in lv] == [
        (1, 120, 160), (1, 100, 133), (1, 83, 111), (1, 69, 93)]


def test_gaussian_kernel_normalized():
    k = gaussian_kernel_1d(7, 2.0)
    assert abs(k.sum() - 1.0) < 1e-6
    assert k[3] == k.max()
    np.testing.assert_allclose(k, k[::-1])  # symmetric


def test_gaussian_blur_constant_image():
    img = jnp.full((1, 32, 32), 7.0)
    out = gaussian_blur(img)
    np.testing.assert_allclose(np.asarray(out), 7.0, atol=1e-4)


def test_fast_detects_square_corner():
    # Bright square on dark background: corners of the square are FAST corners.
    img = np.zeros((1, 64, 64), np.float32)
    img[0, 24:40, 24:40] = 200.0
    score = fast_ops.fast_score_map(jnp.asarray(img), border=3)
    s = np.asarray(score[0])
    # Square corners (just inside) should have high score.
    assert s[24, 24] > 50
    assert s[39, 39] > 50
    # Flat regions have no response.
    assert s[32, 32] == 0
    assert s[5, 5] == 0


def test_fast_score_monotone_threshold():
    img = np.zeros((1, 64, 64), np.float32)
    img[0, 30:34, 30:34] = 60.0
    score = np.asarray(fast_ops.fast_score_map(jnp.asarray(img), border=3)[0])
    # Max score bounded by the intensity step.
    assert score.max() <= 60.0 + 1e-3
    assert score.max() > 10.0


def test_select_keypoints_uniform(frame):
    score = fast_ops.fast_score_map(jnp.asarray(frame[None]), border=19)
    xy, resp, valid = fast_ops.select_keypoints(
        score, n_max=128, ini_th=20.0, min_th=7.0, cell=16)
    xy = np.asarray(xy[0])
    valid = np.asarray(valid[0])
    assert valid.sum() > 60
    v = xy[valid]
    # In-bounds with border margin.
    assert (v[:, 0] >= 19).all() and (v[:, 0] < 160 - 19).all()
    assert (v[:, 1] >= 19).all() and (v[:, 1] < 120 - 19).all()
    # Spatial uniformity: selection covers many distinct 16px cells and is
    # balanced (per-cell cap = topk_per_cell), instead of clustering on the
    # strongest texture region.
    from collections import Counter
    cell_counts = Counter(map(tuple, (v // 16).tolist()))
    assert len(cell_counts) > 35          # usable area is ~8x5=40 cells
    assert max(cell_counts.values()) <= 4  # per-cell top-K cap respected


def test_pattern_standard_and_bounded():
    p1 = make_pattern()
    assert p1.shape == (256, 4)
    # Standard published ORB table: coords in [-13, 12], every
    # rotation-rounded offset within PATCH_RADIUS=18.
    assert p1.min() == -13 and p1.max() == 12
    n1 = np.hypot(p1[:, 0], p1[:, 1])
    n2 = np.hypot(p1[:, 2], p1[:, 3])
    assert max(n1.max(), n2.max()) <= 18.5
    # First row of bit_pattern_31_ (public constant): (8,-3) vs (9,5).
    np.testing.assert_array_equal(p1[0], [8, -3, 9, 5])


def test_pack_unpack_roundtrip(rng):
    bits = rng.integers(0, 2, size=(5, 256)).astype(np.uint32)
    packed = pack_bits(jnp.asarray(bits))
    assert packed.shape == (5, 8)
    out = np.asarray(unpack_bits(packed))
    np.testing.assert_array_equal(out, bits)


def test_hamming_matmul_vs_popcount(rng):
    a = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(24, 8), dtype=np.uint32)
    D = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    # Reference popcount.
    for i in [0, 5, 15]:
        for j in [0, 7, 23]:
            d_ref = sum(bin(int(a[i, k]) ^ int(b[j, k])).count("1") for k in range(8))
            assert D[i, j] == d_ref
    # Self-distance is 0.
    Dself = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(a)))
    assert (np.diag(Dself) == 0).all()
    # Pairwise path agrees.
    Dp = np.asarray(hamming.distance_pairwise(jnp.asarray(a[:16]), jnp.asarray(b[:16])))
    for i in [0, 3]:
        assert Dp[i] == D[i, i]


@pytest.fixture(scope="module")
def extractor():
    cfg = ORBConfig(n_features=256, n_levels=4, scale_factor=1.2)
    return ORBExtractor(cfg, 120, 160)


def test_extractor_basic(frame, extractor):
    fs = extractor(jnp.asarray(frame[None]))
    valid = np.asarray(fs.valid[0])
    assert fs.n_slots == 256
    assert valid.sum() > 100
    xy = np.asarray(fs.xy[0])[valid]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 160).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 120).all()
    oct_ = np.asarray(fs.octave[0])[valid]
    assert oct_.min() == 0 and oct_.max() <= 3
    ang = np.asarray(fs.angle[0])[valid]
    assert (ang >= 0).all() and (ang < 2 * np.pi + 1e-6).all()
    # Descriptors are not degenerate (not all zeros/ones).
    desc = np.asarray(fs.desc[0])[valid]
    bits = np.asarray(unpack_bits(jnp.asarray(desc)))
    frac = bits.mean()
    assert 0.2 < frac < 0.8


def test_extractor_descriptor_stability(frame, extractor):
    """Descriptors of the same scene under a tiny brightness change should
    match with low Hamming distance (robustness sanity)."""
    fs1 = extractor(jnp.asarray(frame[None]))
    fs2 = extractor(jnp.asarray(frame[None] * 1.05 + 2.0))
    v1 = np.asarray(fs1.valid[0])
    v2 = np.asarray(fs2.valid[0])
    d1 = np.asarray(fs1.desc[0])
    d2 = np.asarray(fs2.desc[0])
    xy1 = np.asarray(fs1.xy[0])
    xy2 = np.asarray(fs2.xy[0])
    # For each valid kp in 1, find nearest spatial kp in 2 and compare desc.
    matched = 0
    low = 0
    for i in np.nonzero(v1)[0][:100]:
        dist2 = np.linalg.norm(xy2[v2] - xy1[i], axis=1)
        j = np.argmin(dist2)
        if dist2[j] < 2.0:
            matched += 1
            jj = np.nonzero(v2)[0][j]
            hd = sum(bin(int(d1[i, k]) ^ int(d2[jj, k])).count("1") for k in range(8))
            if hd <= 50:
                low += 1
    assert matched > 30
    assert low > 0.8 * matched


def test_binned_descriptors_match_dense_oracle():
    """The sorted single-bin-chunk descriptor path must be bit-identical to
    the dense all-bins formulation (integer-valued patches make the sign of
    the f32-accumulated contraction order-independent)."""
    from orb_slam_system_tpu.ops.brief import (
        PATCH_RADIUS, compute_descriptors, compute_descriptors_dense)

    rng = np.random.default_rng(3)
    P = 2 * PATCH_RADIUS + 1
    for B, N in [(1, 5), (2, 37), (3, 130)]:
        patches = rng.integers(0, 256, size=(B, N, P, P)).astype(np.float32)
        angles = rng.uniform(0, 2 * np.pi, size=(B, N)).astype(np.float32)
        got = np.asarray(compute_descriptors(
            jnp.asarray(patches), jnp.asarray(angles)))
        want = np.asarray(compute_descriptors_dense(
            jnp.asarray(patches), jnp.asarray(angles)))
        np.testing.assert_array_equal(got, want)


def test_top_n_select_matches_lax_top_k_set():
    """_top_n_select must pick exactly lax.top_k's element set (ties at the
    threshold broken toward lower index), including -inf padding rows."""
    import jax

    rng = np.random.default_rng(5)
    B, M, n = 3, 400, 37
    key = rng.normal(size=(B, M)).astype(np.float32)
    key[key < -0.5] = -np.inf
    # Inject exact ties around the likely threshold region.
    key[0, 10:30] = key[0, 50]
    key[1, :] = -np.inf                      # fewer than n finite
    key[1, :5] = 1.0
    jkey = jnp.asarray(key)
    want_vals, want_idx = jax.lax.top_k(jkey, n)
    got_idx, got_vals, filled = fast_ops._top_n_select(jkey, n)
    for b in range(B):
        gi = np.asarray(got_idx[b])[np.asarray(filled[b])]
        wi = np.asarray(want_idx[b])[: len(gi)]
        assert set(gi.tolist()) == set(wi.tolist()), b
        assert np.asarray(filled[b]).sum() == n  # -inf rows still fill


def test_select_keypoints_multi_matches_per_level(frame):
    """The fused multi-level selection must equal per-level select_keypoints
    exactly (same candidates, same ordering semantics)."""
    img = jnp.asarray(np.stack([frame, frame[::-1]]))  # B=2
    shapes = [(120, 160), (100, 133), (83, 111)]
    scores = []
    for (h, w) in shapes:
        from orb_slam_system_tpu.ops.pyramid import resize_bilinear_matmul
        lvl = resize_bilinear_matmul(img, h, w)
        scores.append(fast_ops.fast_score_map(lvl, border=19))
    budgets = [96, 64, 32]
    multi = fast_ops.select_keypoints_multi(
        scores, budgets, ini_th=20.0, min_th=7.0, cell=16)
    for score, n_l, (xy_m, resp_m, valid_m) in zip(scores, budgets, multi):
        xy, resp, valid = fast_ops.select_keypoints(
            score, n_max=n_l, ini_th=20.0, min_th=7.0, cell=16)
        np.testing.assert_array_equal(np.asarray(valid_m), np.asarray(valid))
        v = np.asarray(valid)
        np.testing.assert_array_equal(np.asarray(xy_m)[v], np.asarray(xy)[v])
        np.testing.assert_allclose(np.asarray(resp_m)[v],
                                   np.asarray(resp)[v], rtol=1e-6)


def _descriptor_case(shape, rng):
    from orb_slam_system_tpu.ops.brief import (
        PATCH_RADIUS, compute_descriptors, compute_descriptors_dense)
    B, N = shape
    P = 2 * PATCH_RADIUS + 1
    patches = jnp.asarray(
        rng.integers(0, 256, size=(B, N, P, P)).astype(np.float32))
    angles = jnp.asarray(
        rng.uniform(0, 2 * np.pi, size=(B, N)).astype(np.float32))
    got = compute_descriptors(patches, angles)
    return np.asarray(got), np.asarray(compute_descriptors_dense(
        patches, angles)), 0.0


def _seg_sum_case(shape, rng):
    from orb_slam_system_tpu.solvers.local_ba import _seg_sum
    n, E, width = shape
    lead = n if isinstance(n, tuple) else (n,)
    idx = tuple(rng.integers(0, k, size=E).astype(np.int32) for k in lead)
    blocks = rng.normal(size=(E,) + width).astype(np.float32)
    want = np.zeros(lead + width, np.float64)
    np.add.at(want, idx, blocks.astype(np.float64))
    got = _seg_sum(tuple(jnp.asarray(i) for i in idx) if len(lead) > 1
                   else jnp.asarray(idx[0]), jnp.asarray(blocks), n)
    # f32 sums of up to E/n terms of unit size, in any order.
    return np.asarray(got, np.float64), want, 1e-4 * np.sqrt(E)


@pytest.mark.parametrize("path,shape", [
    ("descriptors", (1, 200)),             # straddles a 128-row chunk
    ("descriptors", (4, 129)),
    ("seg_sum", (16, 8192, (6, 6))),        # camera Hessian blocks
    ("seg_sum", (2048, 8192, (3,))),        # point gradients
    ("seg_sum", ((16, 512), 2048, (6, 3))),  # camera-point cross blocks
])
def test_kept_paths_match_oracles(path, shape):
    """The one descriptor path (bin-sorted chunks) and the one BA
    segment-sum path (scatter-add) against their plain oracles: the
    all-bins dense contraction bit for bit, and a float64 np.add.at."""
    rng = np.random.default_rng(11)
    case = {"descriptors": _descriptor_case, "seg_sum": _seg_sum_case}[path]
    got, want, atol = case(shape, rng)
    assert got.shape == want.shape
    if atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
