"""The fused audit refinement step: evidence → grouping → consensus.

One jitted XLA program per shape bucket: packed reads in, refined
breakpoints out.  This is the batched device equivalent of the reference's
whole per-record hot path (audit.c:50-236 + refinement.c), batched over
many refine tasks ("windows") at once instead of one VCF record per
thread.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .cigar import extract_read_candidates, group_candidates_by_window
from .consensus import consensus_pos_batch


@dataclasses.dataclass
class AuditBatch:
    """Host-packed, fixed-shape batch of refine tasks.

    reads axis N: ops/lens [N, O], pos/n_ops/window_id [N]
    window axis B: kind/inter_start/inter_end/imprecise_pos [B]
    Padding reads have n_ops == 0 and window_id == B.
    """

    ops: np.ndarray
    lens: np.ndarray
    pos: np.ndarray
    n_ops: np.ndarray
    window_id: np.ndarray
    kind: np.ndarray
    inter_start: np.ndarray
    inter_end: np.ndarray
    imprecise_pos: np.ndarray

    @property
    def num_reads(self) -> int:
        return int(self.ops.shape[0])

    @property
    def num_windows(self) -> int:
        return int(self.kind.shape[0])


@functools.partial(
    jax.jit,
    static_argnames=("min_count", "interval", "range_", "sweep_width"),
)
def audit_consensus_step(
    locs: jnp.ndarray,
    counts: jnp.ndarray,
    imprecise_pos: jnp.ndarray,
    *,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
    sweep_width: int = 128,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Consensus-only device step for host-extracted candidate batches
    (pack.AuditBatchCand): locs [B, K] sorted int32 w/ INT32_MAX pad,
    counts [B] (<= K), imprecise_pos [B].  Returns (refined, sweep_ovf).
    """
    return consensus_pos_batch(
        locs, counts, imprecise_pos,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )


@functools.partial(
    jax.jit,
    static_argnames=("num_windows", "K", "min_count", "interval", "range_",
                     "sweep_width"),
)
def audit_refine_step(
    ops: jnp.ndarray,
    lens: jnp.ndarray,
    pos: jnp.ndarray,
    n_ops: jnp.ndarray,
    window_id: jnp.ndarray,
    kind: jnp.ndarray,
    inter_start: jnp.ndarray,
    inter_end: jnp.ndarray,
    imprecise_pos: jnp.ndarray,
    *,
    num_windows: int,
    K: int,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
    sweep_width: int = 128,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Refine a packed batch of tasks.

    Returns (refined [B] int32 with -1 = NA,
             counts [B] int32 candidate counts,
             overflow [B] bool).  A window whose count exceeds K or whose
    consensus sweep overflowed must be recomputed by the host oracle —
    exactness is never silently lost.
    """
    # Per-read window attributes (gather once; windows beyond B are padding).
    wid_c = jnp.clip(window_id, 0, num_windows - 1)
    kind_r = jnp.take(kind, wid_c)
    istart_r = jnp.take(inter_start, wid_c)
    iend_r = jnp.take(inter_end, wid_c)

    cand, _ = extract_read_candidates(
        ops, lens, pos, n_ops, kind_r, istart_r, iend_r
    )
    locs, counts, read_ovf = group_candidates_by_window(
        cand, window_id, num_windows, K
    )
    refined, sweep_ovf = consensus_pos_batch(
        locs,
        jnp.minimum(counts, K),
        imprecise_pos,
        min_count=min_count,
        interval=interval,
        range_=range_,
        sweep_width=sweep_width,
    )
    overflow = sweep_ovf | read_ovf | (counts > K)
    return refined, counts, overflow


@dataclasses.dataclass
class AuditBatchCSR:
    """Flat (CSR) layout of a packed batch: the host ships only the real
    CIGAR ops — about half the bytes of the padded [N, O] matrices — and
    the device scatters them into the padded layout itself (HBM is much
    closer than the host link).

    flat ops axis T: ops_flat [T] uint8, lens_flat [T] int32 (tail beyond
    sum(n_ops) is unobserved garbage)
    reads axis N: pos/n_ops/window_id [N] (padding rows: n_ops == 0,
    window_id == B)
    window axis B: kind/inter_start/inter_end/imprecise_pos [B]
    """

    ops_flat: np.ndarray
    lens_flat: np.ndarray
    pos: np.ndarray
    n_ops: np.ndarray
    window_id: np.ndarray
    kind: np.ndarray
    inter_start: np.ndarray
    inter_end: np.ndarray
    imprecise_pos: np.ndarray
    ops_width: int              # O bucket for the device-side layout

    @property
    def num_reads(self) -> int:
        return int(self.pos.shape[0])

    @property
    def num_windows(self) -> int:
        return int(self.kind.shape[0])


@functools.partial(jax.jit, static_argnames=("O",))
def csr_to_padded(
    ops_flat: jnp.ndarray,   # [T] uint8/int8
    lens_flat: jnp.ndarray,  # [T] int32
    n_ops: jnp.ndarray,      # [N] int32 (sum == true op count ≤ T)
    *,
    O: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Materialize the padded [N, O] op/len matrices on device.

    Unwritten cells stay zero (op 0 = M with len 0: consumes nothing and
    matches no evidence mask) — and the audit kernel masks by n_ops
    anyway, so only the scatter's own bytes matter."""
    T = ops_flat.shape[0]
    N = n_ops.shape[0]
    starts = jnp.cumsum(n_ops) - n_ops                    # [N] exclusive
    total = starts[-1] + n_ops[-1]
    row = jnp.repeat(jnp.arange(N, dtype=jnp.int32), n_ops,
                     total_repeat_length=T)
    col = jnp.arange(T, dtype=jnp.int32) - jnp.take(starts, row)
    valid = (jnp.arange(T, dtype=jnp.int32) < total) & (col < O)
    idx = jnp.where(valid, row * O + col, N * O)
    ops = jnp.zeros((N * O,), jnp.int8).at[idx].set(
        ops_flat.astype(jnp.int8), mode="drop").reshape(N, O)
    lens = jnp.zeros((N * O,), jnp.int32).at[idx].set(
        lens_flat, mode="drop").reshape(N, O)
    return ops, lens


@functools.partial(
    jax.jit,
    static_argnames=("num_windows", "K", "O",
                     "min_count", "interval", "range_", "sweep_width"),
)
def audit_refine_step_csr(
    ops_flat: jnp.ndarray,
    lens_flat: jnp.ndarray,
    pos: jnp.ndarray,
    n_ops: jnp.ndarray,
    window_id: jnp.ndarray,
    kind: jnp.ndarray,
    inter_start: jnp.ndarray,
    inter_end: jnp.ndarray,
    imprecise_pos: jnp.ndarray,
    *,
    num_windows: int,
    K: int,
    O: int,
    min_count: int = C.CONSENSUS_MIN_COUNT,
    interval: int = C.CONSENSUS_INTERVAL,
    range_: int = C.CONSENSUS_INTERVAL_RANGE,
    sweep_width: int = 128,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """audit_refine_step, but fed the flat CSR layout (host ships ~half
    the bytes; the padded matrices are built in HBM)."""
    ops, lens = csr_to_padded(ops_flat, lens_flat, n_ops, O=O)
    return audit_refine_step(
        ops, lens, pos, n_ops, window_id,
        kind, inter_start, inter_end, imprecise_pos,
        num_windows=num_windows, K=K,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )
