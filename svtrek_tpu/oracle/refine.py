"""Scalar oracle for the breakpoint-refinement semantics.

Models the reference's refinement kernels exactly, including their quirks,
so vectorized device kernels can be verified bit-identical:

- ``consensus_pos``    — position-clustering consensus (refinement.c:41-101)
- ``consensus_lengths``— global-max length consensus (refinement.c:21-39,
                         unused by the reference but kept for parity/tests)
- ``extract_candidates`` — the per-read CIGAR walks of
  refine_start / refine_end / refine_point / refine_ins
  (refinement.c:103-325), parameterized by task kind.

Quirks intentionally mirrored (see SURVEY.md §3.2):
- ``upper_bound`` returns the first index whose value is *less than* the
  query (refinement.c:12-19) — on an ascending array this is 0 or size-1.
- ``refine_end``'s leading-soft-clip evidence records the *post-walk*
  reference position + 1 (wherever the walk stopped), not the alignment
  start (refinement.c:210-221).
- ``refine_point`` only collects evidence when sv_type == SV_INS but is only
  ever invoked with SV_INV, so INV refinement always returns -1
  (refinement.c:231-276, audit.c:228-229).
- D-op evidence requires oplen strictly > 50 (refinement.c:124, 188) while
  I-op evidence requires oplen >= 50 (refinement.c:299).
- The reference advances reference_pos for every op other than I/S —
  including H and P (refinement.c:137-139).
- The CIGAR walk breaks out as soon as reference_pos passes the interval
  end; evidence before the break is kept even if it lies left of the
  interval start (no lower-bound check, refinement.c:123-144).
- ``consensus_pos`` accumulates each cluster total in ``uint64_t``
  (refinement.c:60,82): negative evidence wraps mod 2^64, the mean is an
  *unsigned* 64-bit division, and the result truncates to the low 32 bits
  as a signed int (refinement.c:65,87).  Irrelevant for real BAM positions
  (always >= 0) but mirrored for golden parity (tests/test_golden_refshim).
"""
from __future__ import annotations

from typing import Iterable, Sequence

from .. import constants as C
from ..constants import (
    CIGAR_D,
    CIGAR_I,
    CIGAR_S,
    KIND_DEL_END,
    KIND_DEL_START,
    KIND_INS,
    KIND_INV_END,
    KIND_POINT,
    SV_MIN_LENGTH,
)


def lower_bound(arr: Sequence[int], location: int) -> int:
    """Index of the last element <= location, clamped to [0, size-1].

    Reference: refinement.c:3-10 (linear scan form).
    """
    size = len(arr)
    for i in range(size):
        if arr[i] > location:
            return 0 if i == 0 else i - 1
    return size - 1


def upper_bound(arr: Sequence[int], location: int) -> int:
    """First index whose value is < location, else size-1.

    Reference: refinement.c:12-19.  On an ascending array this degenerates
    to 0 (if arr[0] < location) or size-1; the quirk is load-bearing for
    bit-identical output and is mirrored as-is.
    """
    size = len(arr)
    for i in range(size):
        if arr[i] < location:
            return i
    return size - 1


def consensus_pos(
    locations: Iterable[int],
    pos: int,
    consensus_min_count: int = C.CONSENSUS_MIN_COUNT,
    consensus_interval: int = C.CONSENSUS_INTERVAL,
    consensus_interval_range: int = C.CONSENSUS_INTERVAL_RANGE,
) -> int:
    """Clustering consensus around an imprecise position.

    Reference: refinement.c:41-101.  Returns the refined position or -1.

    Semantics: sort the evidence; sweep left from lower_bound(pos+25) and
    then right from upper_bound(pos-25); at each anchor i form the cluster
    of neighbors within ``consensus_interval`` (toward the sweep direction),
    take the rounded mean; if the cluster is larger than the best so far and
    the mean lands within ``consensus_interval`` of pos, return immediately;
    otherwise keep the candidate only if it is *closer* to pos than the
    current best of that sweep.  Finally prefer the left candidate iff its
    distance is strictly smaller.
    """
    locs = sorted(locations)
    size = len(locs)
    if size < consensus_min_count:
        return -1
    if size == 0:
        # Guard against the reference's UB when consensus_min_count <= 0.
        return -1

    half = SV_MIN_LENGTH // 2

    def cluster_mean(total_u64: int, count: int) -> int:
        # uint64 accumulate + unsigned divide + truncate-to-int32
        # (refinement.c:60-65, 82-87).
        return C.i32(((total_u64 + count // 2) % (1 << 64)) // count)

    best_left = -1
    max_count_left = consensus_min_count - 1
    dist_left = 0x7FFFFFFF

    i = lower_bound(locs, pos + half)
    while i >= 0 and abs(pos - locs[i]) < consensus_interval_range:
        count = 1
        total = locs[i] % (1 << 64)
        j = i - 1
        while j >= 0 and locs[i] <= locs[j] + consensus_interval:
            count += 1
            total = (total + locs[j]) % (1 << 64)
            j -= 1
        candidate = cluster_mean(total, count)
        if count > max_count_left:
            if abs(pos - candidate) < consensus_interval:
                return candidate
            if abs(pos - candidate) < dist_left:
                max_count_left = count
                best_left = candidate
                dist_left = abs(pos - candidate)
        i -= 1

    best_right = -1
    max_count_right = consensus_min_count - 1
    dist_right = 0x7FFFFFFF

    i = upper_bound(locs, pos - half)
    while i < size and abs(pos - locs[i]) < consensus_interval_range:
        count = 1
        total = locs[i] % (1 << 64)
        j = i + 1
        while j < size and locs[j] <= locs[i] + consensus_interval:
            count += 1
            total = (total + locs[j]) % (1 << 64)
            j += 1
        candidate = cluster_mean(total, count)
        if count > max_count_right:
            if abs(pos - candidate) < consensus_interval:
                return candidate
            if abs(pos - candidate) < dist_right:
                max_count_right = count
                best_right = candidate
                dist_right = abs(pos - candidate)
        i += 1

    return best_left if dist_left < dist_right else best_right


def consensus_lengths(
    values: Iterable[int],
    consensus_min_count: int = C.CONSENSUS_MIN_COUNT,
    consensus_interval: int = C.CONSENSUS_INTERVAL,
) -> int:
    """Global-max window consensus over values (e.g. SV lengths).

    Reference: refinement.c:21-39 (``consensus`` — declared but never called
    by the reference; provided here as a real, tested feature).
    """
    vals = sorted(values)
    size = len(vals)
    best = -1
    max_count = consensus_min_count - 1
    for i in range(size):
        count = 1
        j = i + 1
        while j < size and vals[j] <= vals[i] + consensus_interval:
            count += 1
            j += 1
        if count > max_count:
            max_count = count
            best = vals[i]
    return best


def extract_candidates(
    kind: int,
    reads: Sequence[tuple[int, Sequence[tuple[int, int]]]],
    inter_start: int,
    inter_end: int,
) -> list[int]:
    """Collect candidate breakpoint positions from reads for one task.

    ``reads``: sequence of (pos, cigar) where pos is the 0-based alignment
    start and cigar is a list of (op, length) pairs in BAM op codes.
    ``inter_start`` / ``inter_end`` are the (1-based, uint32-wrapped)
    interval bounds as the reference passes them.

    kind selects which reference kernel's evidence rules apply:
      KIND_DEL_START → refine_start(SV_DEL, ...)  refinement.c:103-167
      KIND_DEL_END   → refine_end(SV_DEL, ...)    refinement.c:169-229
      KIND_INS       → refine_ins(...)            refinement.c:278-325
      KIND_POINT     → refine_point(SV_INV, ...)  refinement.c:231-276
    """
    out: list[int] = []
    for pos, cigar in reads:
        if not cigar:
            continue
        rp = C.u32(pos)
        if kind == KIND_DEL_START:
            check_sc = cigar[-1][0] == CIGAR_S
            for op, ln in cigar:
                if op == CIGAR_D and ln > SV_MIN_LENGTH:
                    out.append(C.i32(rp))
                if op != CIGAR_I and op != CIGAR_S:
                    rp = C.u32(rp + ln)
                if rp > inter_end:
                    check_sc = False
                    break
            if check_sc and inter_start <= rp <= inter_end:
                out.append(C.i32(rp))
        elif kind == KIND_DEL_END:
            for op, ln in cigar:
                if op == CIGAR_D and ln > SV_MIN_LENGTH:
                    out.append(C.i32(C.u32(rp + ln + 1)))
                if op != CIGAR_I and op != CIGAR_S:
                    rp = C.u32(rp + ln)
                if rp > inter_end:
                    break
            if cigar[0][0] == CIGAR_S and inter_start <= C.u32(pos) <= inter_end:
                out.append(C.i32(C.u32(rp + 1)))
        elif kind == KIND_INS:
            for op, ln in cigar:
                if op == CIGAR_I and ln >= SV_MIN_LENGTH:
                    out.append(C.i32(rp))
                if op != CIGAR_I and op != CIGAR_S:
                    rp = C.u32(rp + ln)
                if rp > inter_end:
                    break
        elif kind == KIND_INV_END:
            # --refine-inv extension (no reference analog): D>50 op end+1
            # like refine_end, but a leading soft clip records the actual
            # ALIGNMENT START — not refine_end's post-walk quirk.
            for op, ln in cigar:
                if op == CIGAR_D and ln > SV_MIN_LENGTH:
                    out.append(C.i32(C.u32(rp + ln + 1)))
                if op != CIGAR_I and op != CIGAR_S:
                    rp = C.u32(rp + ln)
                if rp > inter_end:
                    break
            if cigar[0][0] == CIGAR_S and inter_start <= C.u32(pos) <= inter_end:
                out.append(C.i32(C.u32(pos)))
        elif kind == KIND_POINT:
            # refine_point collects D evidence only for SV_INS but is only
            # called with SV_INV → collects nothing (refinement.c:250).
            pass
        else:
            raise ValueError(f"unknown task kind {kind}")
    return out


def _c_div(num: int, den: int) -> int:
    """C truncating integer division (toward zero)."""
    q = abs(num) // abs(den)
    return -q if (num < 0) != (den < 0) else q


def window_scan(
    positions: Iterable[int],
    consensus_min_count: int = C.CONSENSUS_MIN_COUNT,
    window_size: int = 1000,
    slide_size: int = 1,
) -> tuple[int, int]:
    """Strided cluster scan over one sub-window's INS evidence.

    Reference: sliding_window.c:60-92 (the dead sliding-window insertion
    discovery, made a real feature here; SURVEY.md §2.11/§3.4).  Anchors
    every ``slide_size`` indices of the sorted evidence open a cluster of
    values within ``window_size``; the best-supported anchor (ascending,
    strictly-greater updates, support >= min_count) reports the rounded
    cluster mean — accumulated in *wrapping* int32 with C truncating
    division, exactly like the reference's plain `int sum`
    (sliding_window.c:78-82).

    Returns (best_position or -1, support or 0).
    """
    locs = sorted(C.i32(p) for p in positions)
    size = len(locs)
    best, max_support = -1, 0
    i = 0
    while i < size:
        end = i
        while end < size and locs[end] - locs[i] <= window_size:
            end += 1
        support = end - i
        if support >= consensus_min_count and support > max_support:
            max_support = support
            s = 0
            for j in range(i, end):
                s = C.i32(s + locs[j])
            best = _c_div(C.i32(s + support // 2), support)
        i += slide_size
    return best, max_support


def refine_task(
    kind: int,
    reads: Sequence[tuple[int, Sequence[tuple[int, int]]]],
    inter_start: int,
    inter_end: int,
    imprecise_pos: int,
    consensus_min_count: int = C.CONSENSUS_MIN_COUNT,
    consensus_interval: int = C.CONSENSUS_INTERVAL,
    consensus_interval_range: int = C.CONSENSUS_INTERVAL_RANGE,
) -> int:
    """Full scalar refinement for one task: evidence walk + consensus.

    Equivalent to one refine_* invocation (refinement.c:103-325).
    Returns the refined position or -1 ("NA").
    """
    cands = extract_candidates(kind, reads, inter_start, inter_end)
    return consensus_pos(
        cands,
        imprecise_pos,
        consensus_min_count,
        consensus_interval,
        consensus_interval_range,
    )
