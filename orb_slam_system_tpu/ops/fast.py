"""FAST corner detection, NMS, and spatially-uniform keypoint selection.

Replaces reference ORBextractor::ComputeKeyPointsOctTree +
DistributeOctTree (src/ORBextractor.cc:228-357): 30px-cell FAST with
ini/min thresholds (20 -> 7 fallback per cell) and quad-tree culling to
per-level budgets.

Design (SURVEY.md §7.1):
  * The 16-pixel Bresenham circle test is evaluated densely for the whole
    image as vectorized elementwise ops (16 shifted views, circular windowed
    min via log-step reductions) — no scalar loops, no data-dependent
    shapes; XLA fuses the chain into a few loop kernels.
  * The per-pixel *score* is the exact FAST-9 corner threshold: the largest t
    for which the pixel is still a corner. One dense score map serves both
    thresholds (corner@t <=> score > t) and NMS, replacing the reference's
    two-pass 20-then-7 refire (src/ORBextractor.cc:288-357).
  * Quad-tree culling is replaced by per-cell ranking: top-K per grid cell,
    then a global top-N where candidates are ordered first by their rank
    inside the cell and then by score. With enough cells this selects the
    best corner of N distinct cells — the same spatial-uniformity contract as
    DistributeOctTree (<= N best-response keypoints, spread out).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3: 16 (dy, dx) offsets in circular order
# (same circle OpenCV's FAST_9_16 uses).
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9: contiguous arc of >= 9 circle pixels

# Global top-N strategy: lax.top_k per level. The radix threshold select
# (_top_n_select_rows) is the alternative layout, selected by setting this
# to False.
TOPK_SELECT = True


def _shift2d(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift img[B,H,W] so out[y,x] = img[y+dy, x+dx]; border values are
    garbage (wrapped) and get masked by the border margin later."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(1, 2))


def fast_score_map(img: jnp.ndarray, border: int) -> jnp.ndarray:
    """Dense FAST-9 corner score. img: f32[B,H,W] -> score f32[B,H,W].

    score(p) = max over the 32 (16 bright + 16 dark) circular arcs of length 9
    of the min ring-vs-center difference; p is a corner at threshold t iff
    score(p) > t. Border pixels (within `border` of the edge) score 0.
    """
    B, H, W = img.shape
    diffs = jnp.stack([_shift2d(img, int(dy), int(dx)) for dy, dx in CIRCLE], axis=0)
    bright = diffs - img[None]          # ring brighter than center
    dark = -bright                      # ring darker than center
    min_b = _partial_min_window(bright, ARC_LEN)
    min_d = _partial_min_window(dark, ARC_LEN)
    score = jnp.maximum(jnp.max(min_b, axis=0), jnp.max(min_d, axis=0))
    # Mask borders.
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    inb = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )
    return jnp.where(inb[None], score, 0.0)


def _partial_min_window(x: jnp.ndarray, win: int) -> jnp.ndarray:
    """Circular min over windows [i, i+win) along axis 0 (len 16), by
    log-step doubling: out_k(i) = min x[i : i+2^k], then fold the remainder."""
    out = x
    done = 1
    while done * 2 <= win:
        out = jnp.minimum(out, jnp.roll(out, -done, axis=0))
        done *= 2
    # Fold remaining elements one roll of the partial at a time.
    rem = win - done
    off = done
    while rem > 0:
        step = min(done, rem)
        # min over [i+off, i+off+step) equals partial-of-size-`step` at i+off;
        # reuse `x` doubling partials by recomputing (cheap: <=4 ops total).
        part = x
        d = 1
        while d < step:
            part = jnp.minimum(part, jnp.roll(part, -d, axis=0))
            d *= 2
        out = jnp.minimum(out, jnp.roll(part, -off, axis=0))
        off += step
        rem -= step
    return out


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression: keep pixels equal to their neighborhood
    max. score: f32[B,H,W] -> suppressed score (0 where not a local max)."""
    pooled = jax.lax.reduce_window(
        score,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(1, 3, 3),
        window_strides=(1, 1, 1),
        padding="SAME",
    )
    # Tie-break toward earlier (row-major) pixel: strictly-greater neighbors
    # suppress; equal neighbors keep both (rare for float scores).
    return jnp.where(score >= pooled, score, 0.0)


def _sortable_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Monotone f32 -> uint32 mapping (IEEE total order incl. +/-inf)."""
    i = jax.lax.bitcast_convert_type(x, jnp.int32)
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    flip = jnp.where(i < 0, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))
    return u ^ flip


def _top_n_select_rows(key: jnp.ndarray, n_rows: jnp.ndarray, n_out: int):
    """Exact per-row top-n selection over key f32[R,M] WITHOUT a sort,
    with a PER-ROW budget n_rows i32[R] (<= n_out): 32-step radix search
    finds each row's n-th largest bit pattern, threshold ties break toward
    lower index (the set lax.top_k picks), survivors are compacted by
    cumsum-scatter into n_out slots.

    Returns (flat_idx i32[R,n_out], keyvals f32[R,n_out], filled
    bool[R,n_out]). Output is in ascending-index order, not key order."""
    R, M = key.shape
    u = _sortable_bits(key)
    n_col = n_rows[:, None]

    # Nibble radix: find each row's n-th largest bit pattern in 8 histogram
    # passes instead of 32 bit passes (each pass is a sequential [R, M]
    # reduce; 4x fewer passes is a direct latency win). Per
    # pass, bucket the next 4 bits of every element still matching the
    # prefix, then pick the largest nibble whose >=-count reaches the
    # row budget — identical threshold semantics to the bitwise search.
    nib_ids = jnp.arange(16, dtype=jnp.uint32)

    def body(i, prefix):
        shift = (jnp.uint32(28) - jnp.uint32(4) * i.astype(jnp.uint32))
        t = jax.lax.shift_right_logical(u, shift)            # [R, M]
        p_hi = jax.lax.shift_right_logical(prefix, shift)    # [R] low nib 0
        in_pref = (t | jnp.uint32(15)) == (p_hi | jnp.uint32(15))[:, None]
        above = jnp.sum((t > (p_hi | jnp.uint32(15))[:, None])
                        .astype(jnp.int32), axis=1)          # [R]
        nib = t & jnp.uint32(15)
        onehot = (nib[..., None] == nib_ids) & in_pref[..., None]
        hist = jnp.sum(onehot.astype(jnp.int32), axis=1)     # [R, 16]
        cum_ge = jnp.cumsum(hist[:, ::-1], axis=1)[:, ::-1]  # >= nibble j
        count_ge = above[:, None] + cum_ge
        # Largest j with count_ge >= budget (monotone non-increasing in j).
        jstar = jnp.maximum(
            jnp.sum((count_ge >= n_col).astype(jnp.int32), axis=1) - 1, 0)
        return prefix | jax.lax.shift_left(jstar.astype(jnp.uint32), shift)

    kth = jax.lax.fori_loop(0, 8, body,
                            jnp.zeros((R,), jnp.uint32))[:, None]
    strict = u > kth
    n_strict = jnp.sum(strict.astype(jnp.int32), axis=1, keepdims=True)
    ties = u == kth
    tie_rank = jnp.cumsum(ties.astype(jnp.int32), axis=1)
    selected = strict | (ties & (tie_rank <= n_col - n_strict))
    pos = jnp.cumsum(selected.astype(jnp.int32), axis=1) - 1
    pos = jnp.where(selected, pos, n_out)                  # n_out -> dropped
    src = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (R, M))

    def scatter_row(p, s):
        return jnp.zeros((n_out,), jnp.int32).at[p].set(s, mode="drop")

    flat_idx = jax.vmap(scatter_row)(pos, src)
    count = jnp.sum(selected.astype(jnp.int32), axis=1, keepdims=True)
    filled = jnp.arange(n_out, dtype=jnp.int32)[None, :] < count
    keyvals = jnp.take_along_axis(key, flat_idx, axis=1)
    return flat_idx, keyvals, filled


def _top_n_select(key: jnp.ndarray, n: int):
    """Exact top-n selection over key f32[B,M] WITHOUT a sort: 32-step
    radix search finds the n-th largest value's bit pattern (count-reduce
    per bit), ties at the threshold are broken toward lower index (same set
    lax.top_k picks), and the survivors are compacted by cumsum-scatter.

    Returns (flat_idx i32[B,n] indices into M, keyvals f32[B,n],
    filled bool[B,n]). Output is in ascending-index order, not key order:
    the n-element result is a SET (callers mask, they don't rank).
    lax.top_k over M ~ 5k was the extractor's hottest op after the kernel
    rounds; this replacement is O(32 reduces + one cumsum)."""
    R = key.shape[0]
    return _top_n_select_rows(key, jnp.full((R,), n, jnp.int32), n)


@functools.partial(
    jax.jit,
    static_argnames=("n_max", "cell", "topk_per_cell", "border"),
)
def select_keypoints(
    score: jnp.ndarray,
    n_max: int,
    ini_th: float,
    min_th: float,
    cell: int = 16,
    topk_per_cell: int = 4,
    border: int = 19,
):
    """Spatially-uniform top-n_max keypoint selection from a dense score map.

    Implements the contract of ComputeKeyPointsOctTree+DistributeOctTree
    (src/ORBextractor.cc:228-357): per-cell FAST with min-threshold fallback
    only in cells lacking a strong (>ini_th) corner, then budget-limited
    selection that prefers covering distinct cells (uniformity) and breaks
    ties by response.

    Returns (xy i32[B, n_max, 2] as (x, y), response f32[B, n_max],
    valid bool[B, n_max]).
    """
    B = score.shape[0]
    vals, idx, hc, wc = _cell_candidates(score, ini_th, min_th, cell,
                                         topk_per_cell)
    flat_key = _order_key(vals, topk_per_cell).reshape(B, -1)
    if not TOPK_SELECT:
        flat_idx, top_vals, filled = _top_n_select(flat_key, n_max)
    else:
        top_vals, flat_idx = jax.lax.top_k(flat_key, n_max)
        filled = jnp.ones_like(flat_idx, bool)
    wc_rows = jnp.full((B,), wc, jnp.int32)
    return _decode_selection(flat_idx, top_vals, filled, vals, idx,
                             wc_rows, cell, topk_per_cell)


def _cell_candidates(score, ini_th, min_th, cell, topk_per_cell):
    """Dense score map -> per-cell top-K candidates.

    Returns (vals f32[B,C,K], idx i32[B,C,K] in-cell flat position, hc, wc).
    """
    B, H, W = score.shape
    s = nms3x3(score)
    # Threshold logic: weak corners only count in cells with no strong corner.
    Hp = ((H + cell - 1) // cell) * cell
    Wp = ((W + cell - 1) // cell) * cell
    s = jnp.pad(s, ((0, 0), (0, Hp - H), (0, Wp - W)))
    hc, wc = Hp // cell, Wp // cell
    cells = s.reshape(B, hc, cell, wc, cell).transpose(0, 1, 3, 2, 4)
    cells = cells.reshape(B, hc * wc, cell * cell)
    cell_max = jnp.max(cells, axis=-1, keepdims=True)
    has_strong = cell_max > ini_th
    eligible = jnp.where(has_strong, cells > ini_th, cells > min_th)
    cells = jnp.where(eligible, cells, 0.0)
    # Per-cell top-K by K iterative max+mask passes: K cheap max-reductions
    # find the same K best responses as a lax.top_k sort of each
    # 256-element cell.
    vals_l, idx_l = [], []
    remaining = cells
    pos = jnp.arange(cells.shape[-1], dtype=jnp.int32)
    for _ in range(topk_per_cell):
        m = jnp.max(remaining, axis=-1)                      # [B, C]
        is_m = remaining == m[..., None]
        # Lowest index among ties (top_k tie-breaking order).
        am = jnp.min(jnp.where(is_m, pos, 1 << 20), axis=-1)
        vals_l.append(m)
        idx_l.append(am.astype(jnp.int32))
        remaining = jnp.where(pos[None, None, :] == am[..., None],
                              -jnp.inf, remaining)
    vals = jnp.stack(vals_l, axis=-1)                        # [B, C, K]
    idx = jnp.stack(idx_l, axis=-1)
    return vals, idx, hc, wc


def _order_key(vals, topk_per_cell):
    """Global candidate ordering: cover cells first (rank 0 of every cell),
    then rank 1, etc.; inside a rank order by response."""
    rank = jnp.arange(topk_per_cell, dtype=jnp.float32)
    rank = rank.reshape((1,) * (vals.ndim - 1) + (-1,))
    smax = jnp.max(vals) + 1.0
    return jnp.where(vals > 0.0, -rank * smax + vals, -jnp.inf)


def _decode_selection(flat_idx, top_vals, filled, vals, idx, wc_rows,
                      cell, topk_per_cell):
    """Selected flat candidate indices -> (xy, resp, valid); wc_rows gives
    each row's cell-grid width (rows may mix pyramid levels)."""
    R = flat_idx.shape[0]
    cell_idx = flat_idx // topk_per_cell
    k_idx = flat_idx % topk_per_cell
    in_cell = jnp.take_along_axis(
        idx.reshape(R, -1), cell_idx * topk_per_cell + k_idx, axis=1)
    resp = jnp.take_along_axis(
        vals.reshape(R, -1), cell_idx * topk_per_cell + k_idx, axis=1)
    wc_col = wc_rows[:, None]
    cy = cell_idx // wc_col
    cx = cell_idx % wc_col
    py = cy * cell + in_cell // cell
    px = cx * cell + in_cell % cell
    valid = (resp > 0.0) & jnp.isfinite(top_vals) & filled
    xy = jnp.stack([px, py], axis=-1).astype(jnp.int32)
    xy = jnp.where(valid[..., None], xy, 0)
    return xy, resp, valid


def select_keypoints_multi(
    scores,
    budgets,
    ini_th: float,
    min_th: float,
    cell: int = 16,
    topk_per_cell: int = 4,
):
    """select_keypoints over ALL pyramid levels in ONE fused program.

    scores: list of f32[B,Hl,Wl] score maps; budgets: per-level n_max.
    The per-level candidate grids are padded to a common cell count and
    stacked level-major into rows of one radix select with PER-ROW budgets
    (_top_n_select_rows) — replacing 8 sequential per-level select chains
    and their per-level dispatches.

    Returns per-level lists (xy i32[B,n_l,2], resp f32[B,n_l],
    valid bool[B,n_l]) — identical contract to per-level select_keypoints.
    """
    B = scores[0].shape[0]
    K = topk_per_cell
    if TOPK_SELECT:
        # Per-level lax.top_k over UNPADDED candidate widths (all inside
        # the one jitted program, so there is no per-level dispatch cost):
        # the fused-row formulation pads every level's candidates to the
        # level-0 cell count, so its single top_k sorts ~3x more keys,
        # ~90% of them padding on the upper levels. The fused rows remain
        # the radix path's layout below.
        out = []
        for s, n_max in zip(scores, budgets):
            vals, idx, hc, wc = _cell_candidates(s, ini_th, min_th, cell,
                                                 K)
            flat_key = _order_key(vals, K).reshape(B, -1)
            top_vals, flat_idx = jax.lax.top_k(flat_key, n_max)
            filled = jnp.ones_like(flat_idx, bool)
            wc_rows = jnp.full((B,), wc, jnp.int32)
            out.append(_decode_selection(flat_idx, top_vals, filled, vals,
                                         idx, wc_rows, cell, K))
        return out
    per = [_cell_candidates(s, ini_th, min_th, cell, K) for s in scores]
    C_max = max(v.shape[1] for v, _, _, _ in per)
    vals = jnp.stack([jnp.pad(v, ((0, 0), (0, C_max - v.shape[1]), (0, 0)))
                      for v, _, _, _ in per])                # [L,B,C_max,K]
    idx = jnp.stack([jnp.pad(i, ((0, 0), (0, C_max - i.shape[1]), (0, 0)))
                     for _, i, _, _ in per])
    L = len(scores)
    R = L * B
    vals = vals.reshape(R, C_max, K)
    idx = idx.reshape(R, C_max, K)
    flat_key = _order_key(vals, K).reshape(R, -1)
    n_rows = jnp.asarray(np.repeat(np.asarray(budgets, np.int32), B))
    n_out = int(max(budgets))
    flat_idx, top_vals, filled = _top_n_select_rows(flat_key, n_rows, n_out)
    wc_rows = jnp.asarray(np.repeat(
        np.asarray([wc for _, _, _, wc in per], np.int32), B))
    xy, resp, valid = _decode_selection(flat_idx, top_vals, filled, vals,
                                        idx, wc_rows, cell, K)
    out = []
    for l in range(L):
        n_l = budgets[l]
        sl = slice(l * B, (l + 1) * B)
        out.append((xy[sl, :n_l], resp[sl, :n_l], valid[sl, :n_l]))
    return out
