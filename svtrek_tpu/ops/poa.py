"""Consensus sequence construction for insertion clusters.

Fills the reference's consensus gap: abPOA is declared as a submodule and
built by its Makefile but never referenced by any reference code
(SURVEY.md §2.14), and the disc-mode MSA step is a TODO
(discover.c:401).  There is therefore no reference behavior to match —
this module defines it.

The algorithm is an **iteratively-refined star MSA with insertion
recovery** (NOT a partial-order graph alignment — the module keeps the
"poa" name only because it fills the reference's abPOA-shaped slot and
the BASELINE.md metric is named "POA DP cells/sec"):

  1. mode selection — single-linkage cluster member lengths; keep the
     majority mode (robust to bimodal insert populations, where a
     global length-medoid would sit between two alleles);
  2. star alignment — align every member to the mode's length-medoid
     with a banded edit DP, projecting member bases onto medoid columns
     AND collecting inserted segments at column boundaries;
  3. voting — per-column base majority (gap majority deletes the
     column) plus boundary-insert majority (an insert supported by more
     than half the members is emitted — this recovers true bases the
     medoid happens to have deleted);
  4. iterate — realign everyone to the round-1 consensus and re-vote
     (the consensus is less noisy than any single member, so round 2
     fixes medoid-biased columns); stop at a fixed point.

The scalar/host implementation below is the semantic anchor; the batched
device DP (ops/poa_batch.py: an XLA row scan) is the performance path
benchmarked as "POA DP cells/sec" (BASELINE.md).
"""
from __future__ import annotations

import numpy as np

_BASES = "ACGTN-"
_ENC = {c: i for i, c in enumerate("ACGTN")}

MATCH = 2
MISMATCH = -4
GAP = -2


def encode(seq: str) -> np.ndarray:
    return np.fromiter(
        (_ENC.get(c, 4) for c in seq.upper()), np.int8, len(seq)
    )


def banded_align_ins(target: np.ndarray, query: np.ndarray, band: int):
    """Global banded alignment; returns (cols, ins) where cols is the
    per-target-column query base (-1 = gap) and ins[j] is the encoded
    query segment inserted before target column j (j in 0..m).
    O(len(t)·band) cells."""
    cols, ptr, n, m = _banded_dp(target, query, band)
    ins: list[list[int]] = [[] for _ in range(m + 1)]
    i, j = n, m
    while i > 0 or j > 0:
        p = ptr[i, j]
        if i > 0 and j > 0 and p == 0:
            cols[j - 1] = query[i - 1]
            i -= 1
            j -= 1
        elif i > 0 and p == 1:
            ins[j].append(int(query[i - 1]))
            i -= 1
        else:
            j -= 1
    for seg in ins:
        seg.reverse()
    return cols, ins


def _banded_dp(target: np.ndarray, query: np.ndarray, band: int):
    """Shared DP fill; returns (cols placeholder, ptr, n, m)."""
    n, m = len(query), len(target)
    band = max(band, abs(n - m) + 1)
    NEG = -(10 ** 9)
    # score[i, j] over query i 0..n, target j 0..m, banded |i-j| <= band
    score = np.full((n + 1, m + 1), NEG, np.int64)
    ptr = np.zeros((n + 1, m + 1), np.int8)     # 0 diag, 1 up(query gap→ins), 2 left(del)
    score[0, : min(m, band) + 1] = GAP * np.arange(min(m, band) + 1)
    ptr[0, :] = 2
    for i in range(1, n + 1):
        lo = max(1, i - band)
        hi = min(m, i + band)
        if i - band <= 0:
            score[i, 0] = GAP * i
            ptr[i, 0] = 1
        qi = query[i - 1]
        for j in range(lo, hi + 1):
            sub = MATCH if qi == target[j - 1] else MISMATCH
            best = score[i - 1, j - 1] + sub
            p = 0
            up = score[i - 1, j] + GAP
            if up > best:
                best, p = up, 1
            left = score[i, j - 1] + GAP
            if left > best:
                best, p = left, 2
            score[i, j] = best
            ptr[i, j] = p
    cols = np.full(m, -1, np.int8)
    return cols, ptr, n, m


def banded_align(target: np.ndarray, query: np.ndarray, band: int):
    """Global banded alignment; returns per-target-column query base
    (-1 = gap), ignoring query insertions.  O(len(t)·band) cells."""
    cols, ptr, n, m = _banded_dp(target, query, band)
    i, j = n, m
    while i > 0 or j > 0:
        p = ptr[i, j]
        if i > 0 and j > 0 and p == 0:
            cols[j - 1] = query[i - 1]
            i -= 1
            j -= 1
        elif i > 0 and p == 1:
            i -= 1
        else:
            j -= 1
    return cols


def majority_length_mode(seqs: list[str]) -> list[str]:
    """Single-linkage cluster member lengths (link when consecutive
    sorted lengths differ by <= max(10, 10% of the shorter)); return the
    members of the largest cluster.  Unimodal noisy sets come back
    whole; bimodal insert populations come back as the majority allele
    (a global length-medoid would sit between the two)."""
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    clusters: list[list[int]] = [[order[0]]]
    for prev, cur in zip(order, order[1:]):
        lp, lc = len(seqs[prev]), len(seqs[cur])
        if lc - lp <= max(10, lp // 10):
            clusters[-1].append(cur)
        else:
            clusters.append([cur])
    best = max(clusters, key=len)
    return [seqs[i] for i in sorted(best)]


def new_vote_state(target: np.ndarray):
    """(votes [m, 6], ins_votes [m+1] Counters) for one voting round."""
    from collections import Counter

    m = len(target)
    return np.zeros((m, 6), np.int32), [Counter() for _ in range(m + 1)]


def accumulate_votes(votes, ins_votes, cols, ins_segs) -> None:
    """Fold one member's alignment into the round state.  ins_segs:
    decoded insert string per boundary ("" = none)."""
    gap = cols < 0
    votes[~gap, cols[~gap]] += 1
    votes[gap, 5] += 1
    for j, seg in enumerate(ins_segs):
        if seg:
            ins_votes[j][seg] += 1


def assemble_consensus(votes, ins_votes, n_members: int) -> str:
    """Emit the consensus: per-column base majority (gap majority drops
    the column) + boundary inserts supported by a strict majority (true
    sequence the target happens to lack, e.g. a medoid deletion)."""
    winner = votes.argmax(axis=1)
    m = votes.shape[0]
    half = n_members // 2
    out: list[str] = []
    for j in range(m + 1):
        if ins_votes[j]:
            seg, n = ins_votes[j].most_common(1)[0]
            if n > half:
                out.append(seg)
        if j < m and winner[j] != 5:
            out.append(_BASES[winner[j]])
    return "".join(out)


def decode_ins(ins: list[list[int]]) -> list[str]:
    return ["".join(_BASES[b] for b in seg) for seg in ins]


def _vote_round(target_s: str, members: list[str], band: int) -> str:
    """One star-alignment + voting round against `target_s`."""
    target = encode(target_s)
    m = len(target)
    votes, ins_votes = new_vote_state(target)
    for s in members:
        if s == target_s:
            votes[np.arange(m), target] += 1
            continue
        cols, ins = banded_align_ins(target, encode(s[: 4 * m]), band)
        accumulate_votes(votes, ins_votes, cols, decode_ins(ins))
    return assemble_consensus(votes, ins_votes, len(members))


def consensus_sequence(seqs: list[str], band: int = 64,
                       max_len: int = 4096, rounds: int = 2) -> str:
    """Iteratively-refined star-MSA consensus (see module docstring)."""
    seqs = [s for s in seqs if s]
    if not seqs:
        return ""
    if len(seqs) == 1:
        return seqs[0]
    members = majority_length_mode(seqs)
    if len(members) == 1:
        return members[0]
    lens = sorted(range(len(members)), key=lambda i: len(members[i]))
    cons = members[lens[len(lens) // 2]]        # length-medoid seed
    if len(cons) > max_len:
        return cons
    for _ in range(max(rounds, 1)):
        new = _vote_round(cons, members, band)
        if not new or new == cons:
            break
        cons = new
    return cons
