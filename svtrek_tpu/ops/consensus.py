"""Vectorized position-clustering consensus (device kernel).

Re-derives the reference's ``consensus_pos`` (refinement.c:41-101) as a
batched, fixed-shape XLA program, bit-identical to the scalar oracle
(`svtrek_tpu.oracle.refine.consensus_pos`):

Key re-formulations (SURVEY.md §7, design translation 1):
- The C inner cluster loops walk contiguous neighbor runs of a *sorted*
  array; each anchor's cluster is a [searchsorted bound, anchor] run, so
  cluster counts and means become searchsorted + prefix sums.  The C
  outer sweeps only ever visit at most ``sweep_width`` anchors, so stats
  are computed *at the swept anchors only* ([B, W] work, not [B, K]).
- The C accumulates cluster totals in uint64 (refinement.c:59).  The
  kernel stays int32-only (64-bit integers are off by default in JAX and
  cost twice the bytes) and still computes the cluster mean exactly:
  cluster values lie within ``interval`` of the anchor L, so
  total = count·L − S with S = Σ(L − value) small; S is recovered
  exactly from *wrapping* int32 prefix sums (the true S always fits),
  and candidate = L + floor((count/2 − S)/count) reproduces the C
  division exactly.
- The C outer sweeps carry a running (max_count, best_distance) state
  with a data-dependent early return — an inherently sequential
  record-chain fold (each accepted step must beat BOTH running values,
  so it is not an associative reduction).  The fold runs as a
  `lax.scan` (`_sweep_scan`).  The sweep is bounded by ``sweep_width``
  steps: the C loop only visits anchors within
  ``consensus_interval_range`` of pos, which is a contiguous index
  window in the sorted array; windows with more in-range anchors than
  sweep_width are flagged for host fallback (exactness is never
  silently lost).

Inputs are padded to a static candidate capacity K with INT32_MAX
sentinels; rows are independent windows (one refine_* task each).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import constants as C

# C int distance sentinel (refinement.c:49).  Python int, not jnp.int32 —
# see the ops/cigar.py PAD comment.
_I32_BIG = 0x7FFFFFFF


def _row_searchsorted(rows: jnp.ndarray, queries: jnp.ndarray, side: str) -> jnp.ndarray:
    """Rowwise searchsorted, batched over rows AND queries.

    An explicit vectorized binary search: ceil(log2(K)) unrolled steps,
    each one [B, Q] gather + compare.  Avoids jnp.searchsorted's sort
    method (a sort of width Q+K per row) and, unlike a broadcast-compare
    count ([B, Q, K] → sum), stays cheap at large K (the grouping
    capacity can reach 8192).
    """
    B, K = rows.shape
    steps = max(1, K.bit_length())  # search space is [0, K]: K+1 values
    lo = jnp.zeros(queries.shape, jnp.int32)          # count of elems "before"
    hi = jnp.full(queries.shape, K, jnp.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(rows, mid, axis=1)
        before = (v < queries) if side == "left" else (v <= queries)
        lo = jnp.where(before, mid + 1, lo)
        hi = jnp.where(before, hi, mid)
    return lo


def _anchor_stats(locs, n, anchor_idx, loc_a, interval: int):
    """Cluster count/candidate at the given anchors, both directions.

    locs: [B, K] int32 sorted ascending, INT32_MAX padding;
    anchor_idx/loc_a: [B, W].  Returns (cand_l, count_l, cand_r,
    count_r), each [B, W].

    Left cluster at anchor i  = {j <= i : locs[i] - locs[j] <= interval}
    (refinement.c:61-64); right cluster at anchor i =
    {j >= i : locs[j] - locs[i] <= interval} (refinement.c:83-86); both
    are contiguous runs of the sorted row.  candidate reproduces
    floor((total + count/2)/count) with uint64 total via an int32
    wrap-safe delta-sum (see module docstring).

    Formulation: masked [B, W, K] COMPARE-REDUCES, not binary search —
    sortedness makes "members of anchor i's run" a pure predicate
    (j <= i AND locs[j] >= lo, resp. i <= j < n AND locs[j] <= hi), so
    count and sum are one fused reduction each, where a rowwise binary
    search pays ~7 take_along_axis gathers per bound; the O(W·K)
    broadcast form is plain compare+add work that XLA fuses into the
    reduction without materializing the [B, W, K] mask.
    """
    # queries clamp: values near INT32_MAX are padding; their stats are
    # never used (padded anchors are inactive in the sweep).
    q_lo = jnp.where(loc_a >= _I32_BIG - interval, loc_a, loc_a - interval)
    q_hi = jnp.where(loc_a >= _I32_BIG - interval, loc_a, loc_a + interval)

    K = locs.shape[1]
    a3 = anchor_idx[:, :, None]                            # [B, W, 1]

    # Chunk the K axis (static unrolled loop): keeps any materialized
    # [B, W, chunk] intermediate bounded at the 8192 candidate cap (a
    # backend that does not fuse the mask into the reduce materializes
    # it), with identical results — counts and wrap-safe sums are
    # chunkwise additive.
    CHUNK = 2048
    count_l = sum_l = count_r = sum_r = jnp.int32(0)
    for c0 in range(0, K, CHUNK):
        c1 = min(c0 + CHUNK, K)
        jidx = jnp.arange(c0, c1, dtype=jnp.int32)[None, None, :]
        lrow = locs[:, None, c0:c1]                        # [B, 1, c]
        in_l = (jidx <= a3) & (lrow >= q_lo[:, :, None])
        count_l = count_l + jnp.sum(in_l, axis=2, dtype=jnp.int32)
        sum_l = sum_l + jnp.sum(jnp.where(in_l, lrow, 0), axis=2,
                                dtype=jnp.int32)
        in_r = (jidx >= a3) & (jidx < n[:, None, None]) & \
            (lrow <= q_hi[:, :, None])
        count_r = count_r + jnp.sum(in_r, axis=2, dtype=jnp.int32)
        sum_r = sum_r + jnp.sum(jnp.where(in_r, lrow, 0), axis=2,
                                dtype=jnp.int32)

    # S = count*L − Σ values  (true value small, exact under int32 wrap)
    s_l = count_l * loc_a - sum_l
    cand_l = loc_a + (count_l // 2 - s_l) // jnp.maximum(count_l, 1)
    s_r = sum_r - count_r * loc_a
    count_r_safe = jnp.maximum(count_r, 1)
    cand_r = loc_a + (s_r + count_r_safe // 2) // count_r_safe

    return cand_l, count_l, cand_r, count_r


def _sweep_scan(active, cand_at, count_at, pos, min_count: int, interval: int,
                allow: jnp.ndarray):
    """One consensus sweep as a batched sequential fold
    (refinement.c:58-76 / 80-98).  active/cand_at/count_at: [B, W]
    already gathered at anchors.  Named "sweep_fold" in profiler
    traces."""
    dist_at = jnp.abs(pos[:, None] - cand_at)

    def body(carry, xs):
        max_count, best_dist, best_val, returned, ret_val = carry
        step_active, c_k, n_k, d_k = xs
        live = step_active & allow & (~returned)
        bigger = live & (n_k > max_count)
        ret_now = bigger & (d_k < interval)
        upd = bigger & (~ret_now) & (d_k < best_dist)

        returned = returned | ret_now
        ret_val = jnp.where(ret_now, c_k, ret_val)
        max_count = jnp.where(upd, n_k, max_count)
        best_val = jnp.where(upd, c_k, best_val)
        best_dist = jnp.where(upd, d_k, best_dist)
        return (max_count, best_dist, best_val, returned, ret_val), None

    # Derive the carry init from `pos` (not fresh constants) so it
    # inherits the varying-manual-axes type under shard_map — fresh
    # constants would be unvarying and fail lax.scan's carry typecheck.
    z = pos * 0
    init = (
        z + (min_count - 1),
        z + _I32_BIG,
        z - 1,
        z != 0,
        z - 1,
    )
    xs = (active.T, cand_at.T, count_at.T, dist_at.T)
    # Moderate unroll: each step is a handful of elementwise [B] ops, so
    # the rolled loop is mostly per-iteration overhead; full unroll blows
    # up XLA compile time superlinearly at W>=64.
    with jax.named_scope("sweep_fold"):
        (max_count, best_dist, best_val, returned, ret_val), _ = \
            jax.lax.scan(body, init, xs, unroll=8)
    return returned, ret_val, best_val, best_dist


@functools.partial(
    jax.jit,
    static_argnames=("min_count", "interval", "range_", "sweep_width"),
)
def consensus_pos_batch(
    locs: jnp.ndarray,
    n: jnp.ndarray,
    pos: jnp.ndarray,
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
    sweep_width: int = 128,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched consensus_pos. Bit-identical to refinement.c:41-101 for
    windows without sweep overflow.

    locs: [B, K] int32, sorted ascending per row, INT32_MAX padding.
    n:    [B] int32 valid counts;  pos: [B] int32 imprecise positions.
    Returns (refined [B] int32 with -1 = NA,
             overflow [B] bool — sweep window exceeded; recompute those
             rows on the host for exactness).
    """
    B, K = locs.shape
    n = n.astype(jnp.int32)
    pos = pos.astype(jnp.int32)
    half = C.SV_MIN_LENGTH // 2
    W = min(sweep_width, K)

    k_idx = jnp.arange(W, dtype=jnp.int32)[None, :]

    # point = lower_bound(locs, pos + 25): last index <= query, clamped
    # (refinement.c:3-10, 56).
    sr = _row_searchsorted(locs, (pos + half)[:, None], "right")
    point_l = jnp.clip(sr[:, 0].astype(jnp.int32) - 1, 0, jnp.maximum(n - 1, 0))

    # One [B, W, K] masked reduce replaces the [B, W] take_along_axis
    # row gathers (see _anchor_stats).
    def _locs_at(idx):
        out = jnp.int32(0)
        for c0 in range(0, K, 2048):   # chunked like _anchor_stats
            c1 = min(c0 + 2048, K)
            out = out + jnp.sum(
                jnp.where(jnp.arange(c0, c1, dtype=jnp.int32)[None, None, :]
                          == idx[:, :, None], locs[:, None, c0:c1], 0),
                axis=2, dtype=jnp.int32)
        return out

    idx_l = point_l[:, None] - k_idx                        # descending walk
    in_bounds_l = idx_l >= 0
    idx_l_c = jnp.clip(idx_l, 0, K - 1)
    loc_at_l = _locs_at(idx_l_c)
    ok_l = in_bounds_l & (jnp.abs(pos[:, None] - loc_at_l) < range_)
    active_l = jnp.cumsum(jnp.where(ok_l, 0, 1), axis=1) == 0  # cumulative AND
    # Overflow: the sweep was still in-range at its last step AND more
    # anchors existed beyond the window.
    ovf_l = active_l[:, -1] & (point_l - (W - 1) > 0)

    # point = upper_bound(locs, pos - 25): 0 if locs[0] < query else size-1
    # (refinement.c:12-19, 78) — quirk mirrored.
    first_elem = locs[:, 0]
    point_r = jnp.where(
        first_elem < pos - half,
        jnp.zeros((B,), jnp.int32),
        jnp.maximum(n - 1, 0),
    )
    idx_r = point_r[:, None] + k_idx                        # ascending walk
    in_bounds_r = idx_r < n[:, None]
    idx_r_c = jnp.clip(idx_r, 0, K - 1)
    loc_at_r = _locs_at(idx_r_c)
    ok_r = in_bounds_r & (jnp.abs(pos[:, None] - loc_at_r) < range_)
    active_r = jnp.cumsum(jnp.where(ok_r, 0, 1), axis=1) == 0
    ovf_r = active_r[:, -1] & (point_r + (W - 1) < n - 1)

    # Cluster stats at the swept anchors only ([B, W], not [B, K]).
    cand_l, count_l, _, _ = _anchor_stats(
        locs, n, idx_l_c, loc_at_l, interval)
    _, _, cand_r, count_r = _anchor_stats(
        locs, n, idx_r_c, loc_at_r, interval)

    allow_all = jnp.ones((B,), bool)
    ret_l, retv_l, best_l, dist_l = _sweep_scan(
        active_l, cand_l, count_l, pos, min_count, interval, allow_all)
    ret_r, retv_r, best_r, dist_r = _sweep_scan(
        active_r, cand_r, count_r, pos, min_count, interval, ~ret_l)
    # Final selection (refinement.c:100): left wins only on strictly
    # smaller distance.
    final = jnp.where(dist_l < dist_r, best_l, best_r)
    out = jnp.where(ret_l, retv_l, jnp.where(ret_r, retv_r, final))

    invalid = (n < min_count) | (n <= 0)
    out = jnp.where(invalid, jnp.int32(-1), out)
    overflow = (ovf_l | ovf_r) & (~invalid)
    return out, overflow


@functools.partial(jax.jit, static_argnames=("min_count", "interval"))
def consensus_lengths_batch(
    vals: jnp.ndarray,
    n: jnp.ndarray,
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
) -> jnp.ndarray:
    """Batched global-max window consensus (refinement.c:21-39).

    vals: [B, K] int32 sorted ascending, INT32_MAX padding; n: [B] counts.
    The winner is the *first* anchor (ascending scan, strictly-greater
    updates; refinement.c:27-37) attaining the maximal count.
    """
    B, K = vals.shape
    idx = jnp.arange(K, dtype=jnp.int32)[None, :]
    q_hi = jnp.where(vals >= _I32_BIG - interval, vals, vals + interval)
    last = _row_searchsorted(vals, q_hi, "right").astype(jnp.int32) - 1
    last = jnp.minimum(last, jnp.maximum(n[:, None] - 1, 0))
    count = jnp.where(idx < n[:, None], last - idx + 1, 0)
    best = jnp.max(count, axis=1)
    first_best = jnp.argmax(count == best[:, None], axis=1)
    win = jnp.take_along_axis(vals, first_best[:, None].astype(jnp.int32), axis=1)[:, 0]
    ok = (best > (min_count - 1)) & (n > 0)
    return jnp.where(ok, win, jnp.int32(-1))
