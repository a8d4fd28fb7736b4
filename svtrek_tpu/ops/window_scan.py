"""Windowed INS discovery kernel (device).

Makes the reference's dead sliding-window insertion-discovery routine a
real feature (sliding_window.c:8-97 is compiled into the reference
binary but unreachable: no call site, and its header declares a
mismatched name — SURVEY.md §2.11, §3.4).  Semantics re-derived, not
ported:

Per sub-window (one batch row): evidence positions are reference
positions of INS CIGAR ops >= SV_MIN_LENGTH (sliding_window.c:33-46,
identical to the refine_ins rule, so evidence extraction reuses
`ops.cigar.extract_read_candidates` with KIND_INS).  Over the *sorted*
evidence array, anchors every ``slide_size`` indices open a cluster
[anchor, last value <= anchor value + window_size] (sliding_window.c:
70-75); the best-supported anchor (ascending scan, strictly-greater
updates, support >= consensus_min_count; sliding_window.c:76-83) wins
and reports the rounded cluster mean.

The C inner loops vectorize completely — no sequential fold this time:
cluster ends are a rowwise searchsorted, supports come from index
arithmetic, the "first strictly-greater update wins" scan is an
argmax-of-first-maximum, and the cluster mean is a prefix-sum gather.
The C accumulates the mean in a plain ``int`` (sliding_window.c:78-82),
so the kernel mirrors int32 *wrapping* sums and C truncating division
(lax.div) for bit-identical results even on overflow.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import constants as C
from .consensus import _row_searchsorted

# Python int, not jnp.int32 — see ops/cigar.py PAD comment (device-const
# jit captures poison the runtime's fast dispatch path).
_I32_BIG = 0x7FFFFFFF


@functools.partial(
    jax.jit, static_argnames=("min_count", "window_size", "slide_size")
)
def window_scan_batch(
    locs: jnp.ndarray,   # [B, K] int32 sorted ascending, INT32_MAX padding
    n: jnp.ndarray,      # [B] int32 valid counts
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    window_size: int = 1000,
    slide_size: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched sliding-window INS cluster scan.

    Returns (best_pos [B] int32 with -1 = no hit,
             best_support [B] int32, 0 when no hit) — the per-sub-window
    candidate/support pair of sliding_window.c:67-84.
    """
    B, K = locs.shape
    n = n.astype(jnp.int32)
    idx = jnp.arange(K, dtype=jnp.int32)[None, :]

    # Wrapping int32 prefix sums (C sums into int; sliding_window.c:78-81).
    masked = jnp.where(locs >= _I32_BIG, 0, locs)
    prefix = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jnp.cumsum(masked, axis=1, dtype=jnp.int32)], axis=1)

    # Cluster end per anchor: first index whose value exceeds
    # locs[i] + window_size (sliding_window.c:72-74).  All j < i also
    # satisfy the <= bound on a sorted row, so searchsorted-right works.
    q = jnp.where(locs >= _I32_BIG - window_size, locs, locs + window_size)
    end = _row_searchsorted(locs, q, "right").astype(jnp.int32)
    end = jnp.minimum(end, n[:, None])
    support = end - idx

    eligible = (idx < n[:, None]) & (idx % slide_size == 0) \
        & (support >= min_count)
    sup_m = jnp.where(eligible, support, 0)
    best_support = jnp.max(sup_m, axis=1)
    # Ascending anchor scan with strictly-greater updates keeps the FIRST
    # maximal-support anchor (sliding_window.c:76) — argmax returns the
    # first maximum.
    best_anchor = jnp.argmax(sup_m, axis=1).astype(jnp.int32)

    a1 = best_anchor[:, None]
    end_at = jnp.take_along_axis(end, a1, axis=1)[:, 0]
    ssum = jnp.take_along_axis(prefix, end_at[:, None], axis=1)[:, 0] - \
        jnp.take_along_axis(prefix, a1, axis=1)[:, 0]
    sup = jnp.maximum(best_support, 1)
    # (sum + support/2) / support with C int semantics: wrapping sum,
    # truncating division (sliding_window.c:82).
    cand = jax.lax.div(ssum + jax.lax.div(sup, jnp.int32(2)), sup)

    hit = best_support > 0
    return (
        jnp.where(hit, cand, jnp.int32(-1)),
        jnp.where(hit, best_support, 0),
    )
