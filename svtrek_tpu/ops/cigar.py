"""Vectorized CIGAR-walk evidence extraction (device kernel).

Re-derives the reference's per-read sequential CIGAR walks
(refinement.c:103-325) as batched prefix-sum programs (SURVEY.md §7,
design translation 2):

- The running ``reference_pos`` is an exclusive cumulative sum of the
  lengths of ops that advance the reference (every op except I and S —
  including H/P, a reference quirk mirrored exactly; refinement.c:137-139).
- The early ``break`` when reference_pos passes the interval end is a
  prefix condition on the (monotone) cumulative positions, so "op i was
  evaluated" is an elementwise mask, not a loop.
- Candidate evidence (D-ops > 50 bp, I-ops >= 50 bp, soft-clip boundary
  rules) becomes masked selects; per-read candidate lists are compacted by
  a row sort and then grouped into per-window sorted candidate arrays by a
  single device-wide two-key sort.

Shapes are static per (N reads, O ops, C per-read candidates, B windows,
K window candidates) bucket; the host packer (pipeline/pack.py) picks the
bucket.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import constants as C
from ..constants import (
    CIGAR_D,
    CIGAR_I,
    CIGAR_S,
    KIND_DEL_END,
    KIND_DEL_START,
    KIND_INS,
    KIND_INV_END,
    SV_MIN_LENGTH,
)

# Python int, NOT jnp.int32: an eagerly-created jnp scalar is a device
# buffer, and embedding one in a jitted function makes it a captured
# device constant instead of a literal folded into the program.
PAD = C.I32_MAX


@jax.jit
def extract_read_candidates(
    ops: jnp.ndarray,       # [N, O] int8 BAM op codes, anything >8 = padding
    lens: jnp.ndarray,      # [N, O] int32 op lengths (0 padding)
    pos: jnp.ndarray,       # [N] int32 0-based alignment start
    n_ops: jnp.ndarray,     # [N] int32 real op count (0 = padding read)
    kind: jnp.ndarray,      # [N] int32 task kind per read (KIND_*)
    inter_start: jnp.ndarray,  # [N] int32 interval start (1-based, as passed)
    inter_end: jnp.ndarray,    # [N] int32 interval end
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-read candidate positions.

    Returns (cand [N, O+1] int32 with PAD sentinels, count [N] int32).
    Column O holds the (at most one) soft-clip-derived candidate.
    """
    N, O = ops.shape
    col = jnp.arange(O, dtype=jnp.int32)[None, :]
    is_real = col < n_ops[:, None]
    op = ops.astype(jnp.int32)
    ln = lens

    advances = is_real & (op != CIGAR_I) & (op != CIGAR_S)
    adv = jnp.where(advances, ln, 0)
    ref_after = pos[:, None] + jnp.cumsum(adv, axis=1)   # position after op i
    ref_before = ref_after - adv                         # position before op i

    ie = inter_end[:, None]
    # Op i is evaluated iff no earlier op pushed reference_pos past the
    # interval end (the break at refinement.c:141-144 / 205-208 / 316-318).
    prev_after = jnp.concatenate([pos[:, None], ref_after[:, :-1]], axis=1)
    processed = is_real & ((col == 0) | (prev_after <= ie))

    d_mask = processed & (op == CIGAR_D) & (ln > SV_MIN_LENGTH)
    i_mask = processed & (op == CIGAR_I) & (ln >= SV_MIN_LENGTH)

    kd = kind[:, None]
    op_cand_val = jnp.where(
        kd == KIND_DEL_START, ref_before,
        jnp.where((kd == KIND_DEL_END) | (kd == KIND_INV_END),
                  ref_after + 1, ref_before),
    )
    op_cand_mask = jnp.where(
        (kd == KIND_DEL_START) | (kd == KIND_DEL_END) | (kd == KIND_INV_END),
        d_mask,
        jnp.where(kd == KIND_INS, i_mask, False),
    )
    op_cand = jnp.where(op_cand_mask, op_cand_val, PAD)

    # --- soft-clip evidence -------------------------------------------------
    last_idx = jnp.clip(n_ops - 1, 0, O - 1)
    last_op = jnp.take_along_axis(op, last_idx[:, None], axis=1)[:, 0]
    first_op = op[:, 0]
    final_rp = jnp.take_along_axis(ref_after, last_idx[:, None], axis=1)[:, 0]
    exceeded = is_real & (ref_after > ie)
    no_break = ~jnp.any(exceeded, axis=1)
    # first reference position past the interval end (monotone ⇒ the min
    # of all exceeding positions); where none, the final position.
    first_exceed = jnp.min(jnp.where(exceeded, ref_after, PAD), axis=1)
    stop_rp = jnp.where(no_break, final_rp, first_exceed)

    has_ops = n_ops > 0
    # refine_start: trailing soft clip whose (un-broken) alignment end lies
    # in the interval records that end (refinement.c:120, 147-159).
    sc_start_ok = (
        has_ops & (last_op == CIGAR_S) & no_break
        & (inter_start <= final_rp) & (final_rp <= inter_end)
    )
    # refine_end: leading soft clip whose alignment *start* lies in the
    # interval records the post-walk position + 1 (refinement.c:210-221,
    # quirk mirrored: not the alignment start).
    sc_end_ok = (
        has_ops & (first_op == CIGAR_S)
        & (inter_start <= pos) & (pos <= inter_end)
    )
    # --refine-inv (KIND_INV_END): leading soft clip records the actual
    # alignment start — breakpoint evidence, not refine_end's post-walk
    # quirk (this kind is a framework extension; no reference analog).
    sc_val = jnp.where(
        kind == KIND_DEL_START, final_rp,
        jnp.where(kind == KIND_DEL_END, stop_rp + 1,
                  jnp.where(kind == KIND_INV_END, pos, PAD)),
    )
    sc_ok = jnp.where(
        kind == KIND_DEL_START, sc_start_ok,
        jnp.where((kind == KIND_DEL_END) | (kind == KIND_INV_END),
                  sc_end_ok, False),
    )
    sc_col = jnp.where(sc_ok, sc_val, PAD)[:, None]

    cand = jnp.concatenate([op_cand, sc_col], axis=1)
    count = jnp.sum(op_cand_mask, axis=1).astype(jnp.int32) + sc_ok.astype(jnp.int32)
    return cand, count


@functools.partial(jax.jit, static_argnames=("num_windows", "K", "read_cap"))
def group_candidates_by_window(
    cand: jnp.ndarray,        # [N, Cw] int32 per-read candidates, PAD padding
    window_id: jnp.ndarray,   # [N] int32 window per read (>= B ⇒ padding read)
    num_windows: int,
    K: int,
    read_cap: int = 8,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Group per-read candidates into per-window sorted arrays.

    REQUIRES reads to be grouped contiguously by window (ascending
    window_id, padding reads last) — every packer in this framework lays
    batches out that way (pipeline/pack.py), matching how the reference's
    per-thread evidence arrays are window-local (refinement.c:105-135).

    Returns (locs [B, K] int32 sorted ascending with PAD padding,
             counts [B] int32 true per-window candidate counts — may
             exceed K,
             ovf [B] bool — some read exceeded `read_cap` candidates so
             `locs` is incomplete).  Windows with counts > K or ovf must
    fall back to the host oracle — exactness is never silently lost.

    Formulation: (1) per-read compaction [N, Cw] → [N, read_cap] via a
    rank-select (the j-th valid candidate's column is a fused broadcast-
    compare count over the inclusive rank cumsum — no sort, no scatter);
    (2) one small scatter of the ≤ N·read_cap survivors into a gap-free
    stream (reads are window-contiguous so per-window ranges are
    contiguous); (3) a [B, K] gather + row sort.  Versus sorting the raw
    N·Cw stream this drops the scatter volume by Cw/read_cap and the
    row-sort width from Cw·reads to K.
    """
    N, Cw = cand.shape
    valid = (cand < PAD) & (window_id[:, None] < num_windows)
    rank_incl = jnp.cumsum(valid, axis=1, dtype=jnp.int32)     # [N, Cw]
    c_read = rank_incl[:, -1]                                  # true per-read
    read_ovf = c_read > read_cap
    c_eff = jnp.minimum(c_read, read_cap)

    # Rank-select: column of the j-th (1-based) valid candidate is the
    # count of positions with rank_incl < j.
    j = jnp.arange(1, read_cap + 1, dtype=jnp.int32)
    col_j = jnp.sum(
        rank_incl[:, None, :] < j[None, :, None], axis=-1, dtype=jnp.int32
    )                                                          # [N, read_cap]
    small = jnp.take_along_axis(cand, jnp.minimum(col_j, Cw - 1), axis=1)
    jj = jnp.arange(read_cap, dtype=jnp.int32)[None, :]
    small = jnp.where(jj < c_eff[:, None], small, PAD)

    # Gap-free global slot per surviving candidate.
    read_off = jnp.cumsum(c_eff, dtype=jnp.int32) - c_eff      # exclusive
    gidx = read_off[:, None] + jj
    gidx = jnp.where(jj < c_eff[:, None], gidx, N * read_cap)

    flat = jnp.full((N * read_cap,), PAD, jnp.int32)
    flat = flat.at[gidx.reshape(-1)].set(small.reshape(-1), mode="drop")

    wid_c = jnp.minimum(window_id, num_windows)
    counts = jax.ops.segment_sum(
        c_read, wid_c, num_segments=num_windows + 1
    )[:num_windows].astype(jnp.int32)
    counts_eff = jax.ops.segment_sum(
        c_eff, wid_c, num_segments=num_windows + 1
    )[:num_windows].astype(jnp.int32)
    ovf = jax.ops.segment_max(
        read_ovf.astype(jnp.int32), wid_c, num_segments=num_windows + 1
    )[:num_windows] > 0
    w_off = jnp.cumsum(counts_eff, dtype=jnp.int32) - counts_eff

    gather_idx = w_off[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    gather_idx = jnp.clip(gather_idx, 0, N * read_cap - 1)
    locs = jnp.take(flat, gather_idx)
    in_window = jnp.arange(K, dtype=jnp.int32)[None, :] < counts_eff[:, None]
    locs = jnp.where(in_window, locs, PAD)
    locs = jnp.sort(locs, axis=1)
    return locs, counts, ovf
