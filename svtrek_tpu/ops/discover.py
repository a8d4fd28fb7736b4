"""Batched run-length SV scan for disc mode (device kernel).

The completed form of the reference's empty detection stubs
(discover.c:203-222), re-shaped for batching: projected reads arrive as
fixed-shape (op, len) run arrays; reference/read coordinates are
exclusive prefix sums; detection is a masked select — one XLA program
scans thousands of reads at once.  Must agree exactly with the host
scalar `io.gaf.scan_breakpoints`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, CIGAR_EQ, CIGAR_X

BP_NONE, BP_INS, BP_DEL, BP_CLIP = 0, 1, 2, 3


@functools.partial(jax.jit, static_argnames=("min_len",))
def scan_projected_runs(
    ops: jnp.ndarray,        # [N, O] int8 run op codes (9 = padding)
    lens: jnp.ndarray,       # [N, O] int32 run lengths
    n_runs: jnp.ndarray,     # [N] int32
    ref_start: jnp.ndarray,  # [N] int32 backbone coord of first ref op
    *,
    min_len: int = 50,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (bp_type [N, O], ref_pos [N, O], read_pos [N, O]).

    bp_type is BP_NONE except where a run is an INS/DEL >= min_len or a
    leading/trailing soft clip >= min_len; ref_pos/read_pos give the
    0-based backbone / normalized-read offsets of that run's start.
    """
    N, O = ops.shape
    col = jnp.arange(O, dtype=jnp.int32)[None, :]
    real = col < n_runs[:, None]
    op = ops.astype(jnp.int32)
    ln = lens

    is_ref = (op == CIGAR_M) | (op == CIGAR_D) | (op == CIGAR_EQ) | (op == CIGAR_X)
    is_que = (op == CIGAR_M) | (op == CIGAR_I) | (op == CIGAR_S) | \
        (op == CIGAR_EQ) | (op == CIGAR_X)

    ref_adv = jnp.where(real & is_ref, ln, 0)
    que_adv = jnp.where(real & is_que, ln, 0)
    ref_pos = ref_start[:, None] + jnp.cumsum(ref_adv, axis=1) - ref_adv
    read_pos = jnp.cumsum(que_adv, axis=1) - que_adv

    big = real & (ln >= min_len)
    edge = (col == 0) | (col == n_runs[:, None] - 1)
    bp_type = jnp.where(
        big & (op == CIGAR_I), BP_INS,
        jnp.where(
            big & (op == CIGAR_D), BP_DEL,
            jnp.where(big & (op == CIGAR_S) & edge, BP_CLIP, BP_NONE),
        ),
    ).astype(jnp.int32)
    return bp_type, ref_pos, read_pos


@functools.partial(jax.jit, static_argnames=("min_len", "cap"))
def scan_projected_runs_compact(
    ops: jnp.ndarray,
    lens: jnp.ndarray,
    n_runs: jnp.ndarray,
    ref_start: jnp.ndarray,
    *,
    min_len: int = 50,
    cap: int = 2048,
) -> tuple[jnp.ndarray, ...]:
    """scan_projected_runs + on-device compaction: signals are sparse
    (~1% of reads on long-read data), so shipping the dense [N, O]
    matrices back would waste ~99% of the device→host bytes.
    Returns (total, row, bp_type, ref_pos, read_pos, length), each
    selection array [cap], in row-major (read, run) order; entries
    beyond `total` are invalid.  total > cap ⇒ the caller must rescan
    the batch on the host (exactness is never silently lost)."""
    bp_type, ref_pos, read_pos = scan_projected_runs(
        ops, lens, n_runs, ref_start, min_len=min_len)
    N, O = ops.shape
    flat_t = bp_type.reshape(-1)
    hit = flat_t > 0
    total = jnp.sum(hit.astype(jnp.int32))
    idx = jnp.where(hit, jnp.arange(N * O, dtype=jnp.int32), N * O)
    # Smallest `cap` hit indices, ascending == row-major scan order.
    cap_eff = min(cap, N * O)
    sel = -jax.lax.top_k(-idx, cap_eff)[0]
    if cap_eff < cap:
        sel = jnp.concatenate(
            [sel, jnp.full(cap - cap_eff, N * O, jnp.int32)])
    valid = sel < N * O
    sel_c = jnp.minimum(sel, N * O - 1)
    return (
        total,
        jnp.where(valid, sel_c // O, -1),
        jnp.where(valid, flat_t[sel_c], 0),
        ref_pos.reshape(-1)[sel_c],
        read_pos.reshape(-1)[sel_c],
        lens.reshape(-1)[sel_c],
    )


@functools.partial(jax.jit, static_argnames=("O", "min_len", "cap"))
def scan_projected_runs_compact_csr(
    ops_flat: jnp.ndarray,   # [T] int8 (C projector's flat run ops)
    lens_flat: jnp.ndarray,  # [T] int32
    n_runs: jnp.ndarray,     # [N] int32 (sum <= T)
    ref_start: jnp.ndarray,  # [N] int32
    *,
    O: int,
    min_len: int = 50,
    cap: int = 2048,
) -> tuple[jnp.ndarray, ...]:
    """scan_projected_runs_compact fed the flat CSR layout: the host
    ships the C GAF projector's run arrays verbatim (~40% of the padded
    [N, O] bytes at typical 45-run reads) and the device
    scatters them into the padded layout itself (the audit CSR design,
    ops/audit_step.csr_to_padded).  Unwritten cells are op 0 / len 0 —
    scan_projected_runs masks every column >= n_runs, so results are
    identical to the padded path."""
    from .audit_step import csr_to_padded

    ops, lens = csr_to_padded(ops_flat, lens_flat, n_runs, O=O)
    return scan_projected_runs_compact(
        ops, lens, n_runs, ref_start, min_len=min_len, cap=cap)
