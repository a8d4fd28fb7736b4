"""Batched banded edit-distance DP (the "POA DP cells/sec" path).

Semantic anchor: the scalar ``banded_align`` in ops/poa.py — this module
computes the identical per-target-column query bases for a whole batch of
(target, query) pairs in ONE jitted XLA program.  There is no reference
behavior to match: the reference declares abPOA as a submodule but never
calls it (SURVEY.md §2.14) and leaves the disc-mode MSA a TODO
(discover.c:401), so the scalar implementation defines the semantics and
this kernel must reproduce it bit-for-bit (property-tested in
tests/test_poa_batch.py).

Formulation (not an anti-diagonal wavefront):

* one ``lax.scan`` step per QUERY ROW (N steps, not N+M) — each step
  updates the banded row vector of width 2W+1 with vector ops;
* the in-row left-gap recurrence ``score[j] = max(score[j-1]+GAP, c[j])``
  is a max-plus prefix scan: with ``g[k] = c[k] - GAP*k`` it becomes an
  exclusive ``lax.cummax`` — O(width) vectorized, no sequential inner
  loop;
* per-pair band widths are DYNAMIC (traced) inside one STATIC storage
  band W, so pairs with different |n-m| share one compiled program;
* traceback also runs on device: a second scan of N+M steps walking the
  int8 pointer tensor, emitting the query base aligned to each target
  column;
* the whole thing is ``vmap``-ed over the pair batch, so every scan step
  works on a [B, 2W+1] block.

This one program is the DP on every backend.

Scores are int32; NEG is -2^28 so band-invalid cells stay strictly worse
than any reachable score without overflowing when gap terms are added.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .poa import GAP, MATCH, MISMATCH, _BASES, banded_align, encode

NEG = -(1 << 28)


def _dp_one(t, m, q, n, band, *, W: int, unroll: int = 1):
    """Banded DP + traceback for one (target, query) pair.

    t: [M] int8 padded target; q: [N] int8 padded query;
    m, n, band: traced int32 true lengths / band half-width (band <= W).
    Returns (cols [M] int8: query base per target column, -1 = gap;
             ins [M+1] int32: inserted-query-base count per boundary).
    """
    M = t.shape[0]
    N = q.shape[0]
    width = 2 * W + 1
    karr = jnp.arange(width, dtype=jnp.int32)
    gapk = GAP * karr

    # Padded target so row i's bases t[j-1], j = i + k - W, are one
    # dynamic_slice: tbig[i + k] == t[j - 1].  Sized for the LARGEST row
    # start i = N, not just M: dynamic_slice CLAMPS an out-of-range
    # start, so a too-short tbig silently shifted every row i > M + 1
    # onto wrong target bases (latent round-4 bug — hit whenever a
    # query overruns the target's padded bucket by more than one, e.g.
    # m = 1011 in a 1024 bucket against n = 1048; caught by the r5
    # hardware-vs-XLA parity sweep, regression-tested in
    # tests/test_poa_batch.py::test_query_overruns_target_bucket).
    tbig = jnp.full((max(M, N) + 2 * W + 2,), jnp.int8(5))
    tbig = jax.lax.dynamic_update_slice(tbig, t, (W + 1,))

    # Row 0: score[0, j] = GAP*j for 0 <= j <= min(m, band)
    # (scalar poa.py:45); band coordinate k = j + W.
    j0 = karr - W
    row0 = jnp.where(
        (j0 >= 0) & (j0 <= jnp.minimum(m, band)), GAP * j0, NEG
    ).astype(jnp.int32)

    def step(prev, i):
        j = i + karr - W
        tb = jax.lax.dynamic_slice(tbig, (i,), (width,))
        qi = q[i - 1]
        sub = jnp.where(tb == qi, MATCH, MISMATCH)
        # diag (i-1, j-1) is prev[k]; up (i-1, j) is prev[k+1].
        diag = prev + sub
        up = jnp.concatenate([prev[1:], jnp.full((1,), NEG, prev.dtype)]) + GAP
        c = jnp.maximum(diag, up)
        pc = jnp.where(up > diag, jnp.int8(1), jnp.int8(0))  # tie → diag
        validj = (j >= 1) & (j <= m) & (jnp.abs(j - i) <= band)
        cand = jnp.where(validj, c, NEG)
        pcand = pc
        # Left-column boundary score[i, 0] = GAP*i while i <= band
        # (scalar poa.py:50-52) participates as a left-gap source.
        bmask = (j == 0) & (i <= band)
        cand = jnp.where(bmask, GAP * i, cand)
        pcand = jnp.where(bmask, jnp.int8(1), pcand)
        # In-row left gaps: score[k] = max_{d>=1} cand[k-d] + GAP*d
        #                            = GAP*k + max_{k'<k} (cand[k'] - GAP*k')
        g = cand - gapk
        cm = jax.lax.cummax(g, axis=0)
        pexc = jnp.concatenate([jnp.full((1,), NEG, cm.dtype), cm[:-1]])
        left = pexc + gapk
        use_left = validj & (left > cand)  # strict: scalar prefers diag/up
        row = jnp.where(use_left, left, cand)
        prow = jnp.where(use_left, jnp.int8(2), pcand)
        row = jnp.where(validj | bmask, row, NEG)
        return row, prow

    _, ptr = jax.lax.scan(
        step, row0, jnp.arange(1, N + 1, dtype=jnp.int32),
        unroll=unroll,
    )  # ptr[i-1] = pointer row i, int8 [N, width]

    # Traceback (scalar poa.py): diag emits the query base onto the
    # target column; row 0 always moves left; column 0 always moves up.
    # Up moves additionally count an inserted query base at the current
    # target boundary j (scalar banded_align_ins's ins[j]); the host
    # reconstructs the actual segments from the counts because the query
    # is consumed monotonically along the path.
    def tb_step(carry, _):
        i, j, cols, ins = carry
        active = (i > 0) | (j > 0)
        k = jnp.clip(j - i + W, 0, 2 * W)
        p = ptr[jnp.maximum(i - 1, 0), k]
        p = jnp.where(i == 0, jnp.int8(2), p)
        p = jnp.where((j == 0) & (i > 0), jnp.int8(1), p)
        dg = active & (i > 0) & (j > 0) & (p == 0)
        up_ = active & ~dg & (i > 0) & (p == 1)
        lf = active & ~dg & ~up_
        idx = jnp.maximum(j - 1, 0)
        val = jnp.where(dg, q[jnp.maximum(i - 1, 0)], cols[idx])
        cols = cols.at[idx].set(val)
        ins = ins.at[jnp.clip(j, 0, M)].add(up_.astype(jnp.int32))
        i = i - (dg | up_).astype(i.dtype)
        j = j - (dg | lf).astype(j.dtype)
        return (i, j, cols, ins), None

    cols0 = jnp.full((M,), -1, jnp.int8)
    ins0 = jnp.zeros((M + 1,), jnp.int32)
    (_, _, cols, ins), _ = jax.lax.scan(
        tb_step, (n, m, cols0, ins0), None, length=N + M,
        unroll=unroll,
    )
    return cols, ins


# Scan-body unroll factor: both scans' per-step work ([B, 2W+1] row
# updates; a handful of gathers in the traceback) is small, so the
# scans are loop-overhead-bound; unrolling amortizes it with
# bit-identical semantics (lax.scan unroll is pure loop unrolling;
# tests/test_poa_batch.py asserts batch == scalar).
UNROLL = 8


@functools.partial(jax.jit, static_argnames=("W", "unroll"))
def _dp_cols_batch(tpad, ms, qpad, ns, bands, *, W, unroll=UNROLL):
    return jax.vmap(functools.partial(_dp_one, W=W, unroll=unroll))(
        tpad, ms, qpad, ns, bands)


def _pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _nbucket(n: int, lo: int = 16) -> int:
    """Length bucket for the padded pair shapes: pow2 up to 512, then
    quarter-significand steps ({1.0, 1.25, 1.5, 1.75} x 2^k).  The XLA
    DP and traceback scans run one step per padded query row, so a
    1048-base query in a pow2 bucket pays 2048 rows — ~2x dead work;
    the finer steps cap the waste at 25% while keeping the number of
    compiled shape variants small (below 512 rows are cheap and pow2's
    variant economy wins)."""
    if n <= 512:
        return _pow2(n, lo)
    v = 1024
    while v < n:
        v *= 2
    for frac in (10, 12, 14, 16):  # (v/2) x {1.25, 1.5, 1.75, 2.0}
        c = (v // 2) * frac // 8
        if c >= n:
            return c
    return v


def _segments_from_counts(query: np.ndarray, cols: np.ndarray,
                          ins_counts: np.ndarray) -> list[str]:
    """Reconstruct the inserted query segment per boundary from the
    per-boundary counts: the global alignment consumes the query
    monotonically, so boundary j's insert is the next ins_counts[j]
    unconsumed query bases (identical to the scalar
    banded_align_ins segments)."""
    m = len(cols)
    segs = [""] * (m + 1)
    c = 0
    for j in range(m + 1):
        k = int(ins_counts[j])
        if k:
            segs[j] = "".join(_BASES[b] for b in query[c : c + k])
            c += k
        if j < m and cols[j] >= 0:
            c += 1
    return segs


def banded_cols_batch(targets, queries, band: int = 64,
                      band_cap: int = 512):
    """Batched drop-in for ``banded_align_ins`` over pair lists.

    targets/queries: lists of int8 numpy arrays.  Returns
    (cols_list, segs_list): per pair, the per-target-column query bases
    and the decoded inserted segment per boundary.  Pairs whose
    effective band max(band, |n-m|+1) exceeds ``band_cap`` or exceeds
    the target length fall back to the scalar host path (they are rare
    and the wide band would dominate the batch's compiled shape).
    """
    assert len(targets) == len(queries)
    from .poa import banded_align_ins, decode_ins

    nn = len(targets)
    cols_out = [None] * nn
    segs_out = [None] * nn
    dev_idx = []
    for i, (t, q) in enumerate(zip(targets, queries)):
        eb = max(band, abs(len(q) - len(t)) + 1)
        if eb > band_cap or eb >= max(len(t), 1) + len(q):
            cols_out[i], ins = banded_align_ins(t, q, band)
            segs_out[i] = decode_ins(ins)
        else:
            dev_idx.append(i)
    if not dev_idx:
        return cols_out, segs_out
    Mp = _nbucket(max(len(targets[i]) for i in dev_idx))
    Np = _nbucket(max(len(queries[i]) for i in dev_idx))
    Wm = max(
        max(band, abs(len(queries[i]) - len(targets[i])) + 1)
        for i in dev_idx
    )
    W = _pow2(Wm, 16)
    B = len(dev_idx)
    tpad = np.full((B, Mp), 5, np.int8)
    qpad = np.full((B, Np), 5, np.int8)
    ms = np.zeros(B, np.int32)
    ns = np.zeros(B, np.int32)
    bands = np.zeros(B, np.int32)
    for bi, i in enumerate(dev_idx):
        t, q = targets[i], queries[i]
        tpad[bi, : len(t)] = t
        qpad[bi, : len(q)] = q
        ms[bi] = len(t)
        ns[bi] = len(q)
        bands[bi] = max(band, abs(len(q) - len(t)) + 1)
    cols_all, ins_all = (np.asarray(x) for x in _dp_cols_batch(
        tpad, ms, qpad, ns, bands, W=W))
    for bi, i in enumerate(dev_idx):
        cols_out[i] = cols_all[bi, : ms[bi]]
        segs_out[i] = _segments_from_counts(
            queries[i], cols_out[i], ins_all[bi, : ms[bi] + 1])
    return cols_out, segs_out


def consensus_sequence_batch(clusters, band: int = 64,
                             max_len: int = 4096,
                             rounds: int = 2) -> list[str]:
    """Batched consensus: semantics of ``consensus_sequence``
    (ops/poa.py — iteratively-refined star MSA with majority-mode
    selection and insertion recovery) applied to many clusters, with
    every round's member→consensus alignments across ALL clusters fused
    into one device DP batch."""
    from .poa import (
        accumulate_votes, assemble_consensus, majority_length_mode,
        new_vote_state,
    )

    results: list[str | None] = [None] * len(clusters)
    active: dict[int, tuple[list[str], str]] = {}
    for ci, seqs in enumerate(clusters):
        seqs = [s for s in seqs if s]
        if not seqs:
            results[ci] = ""
            continue
        if len(seqs) == 1:
            results[ci] = seqs[0]
            continue
        members = majority_length_mode(seqs)
        if len(members) == 1:
            results[ci] = members[0]
            continue
        order = sorted(range(len(members)), key=lambda i: len(members[i]))
        cons = members[order[len(order) // 2]]
        if len(cons) > max_len:
            results[ci] = cons
            continue
        active[ci] = (members, cons)

    for _ in range(max(rounds, 1)):
        if not active:
            break
        votes = {}
        insv = {}
        pair_ci: list[int] = []
        pair_t: list[np.ndarray] = []
        pair_q: list[np.ndarray] = []
        for ci, (members, cons) in active.items():
            target = encode(cons)
            m = len(target)
            v, iv = new_vote_state(target)
            for s in members:
                if s == cons:
                    v[np.arange(m), target] += 1
                else:
                    pair_ci.append(ci)
                    pair_t.append(target)
                    pair_q.append(encode(s[: 4 * m]))
            votes[ci] = v
            insv[ci] = iv
        if pair_ci:
            all_cols, all_segs = banded_cols_batch(pair_t, pair_q, band)
            for ci, cols, segs in zip(pair_ci, all_cols, all_segs):
                accumulate_votes(votes[ci], insv[ci], cols, segs)
        nxt: dict[int, tuple[list[str], str]] = {}
        for ci, (members, cons) in active.items():
            new = assemble_consensus(votes[ci], insv[ci], len(members))
            if not new or new == cons:
                results[ci] = cons
            else:
                nxt[ci] = (members, new)
        active = nxt
    for ci, (_members, cons) in active.items():  # rounds exhausted
        results[ci] = cons
    return results  # type: ignore[return-value]
