"""Device-mesh sharding for the audit pipeline.

The reference's only parallelism is single-node record parallelism over
pthreads (audit.c:269-293; SURVEY.md §2 'parallelism inventory').  The
device equivalent shards the *window batch* across a 1-D `jax.sharding`
mesh over the local devices (every GPU of a host reaches every other over
NVLink, so the mesh needs no shape beyond the device list): each device owns a contiguous block of refine windows and all the
reads packed for those windows — shared-nothing, exactly like the
reference's per-thread BAM handles, so the only collective is the final
result gather (which jit inserts automatically from the output sharding).

Windows are independent, so scaling is embarrassingly parallel by
construction; ≥80% linear scaling (BASELINE.md) reduces to balanced
packing, which the host packer guarantees by equalizing reads/shard.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..ops.cigar import extract_read_candidates, group_candidates_by_window
from ..ops.consensus import consensus_pos_batch


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def device_label() -> str:
    """What the process computes on, as --verbose and chip_smoke.py
    print it: platform, device kind and count, as JAX reports them."""
    d = jax.devices()
    return (f"platform={d[0].platform} device_kind={d[0].device_kind} "
            f"devices={len(d)}")


_DISTRIBUTED_INITIALIZED = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """jax.distributed bootstrap — the multi-host communication backend
    (SURVEY.md §5 'distributed backend'; replaces the reference's
    single-node pthread model, audit.c:269-293, across hosts).

    Arguments default from the environment so a launcher can export
    SVTREK_COORDINATOR=host:port, SVTREK_NUM_PROCS, SVTREK_PROC_ID and
    run the same CLI command on every host.  No-op (returns the local
    device count) when no coordinator is configured.  Returns the
    *global* device count after initialization.

    Idempotent: safe to call from both the CLI and library entry points.
    """
    global _DISTRIBUTED_INITIALIZED
    coordinator_address = coordinator_address or os.environ.get(
        "SVTREK_COORDINATOR", "")
    if not coordinator_address:
        return jax.local_device_count()
    if not _DISTRIBUTED_INITIALIZED:
        num_processes = int(num_processes if num_processes is not None
                            else os.environ.get("SVTREK_NUM_PROCS", "1"))
        process_id = int(process_id if process_id is not None
                         else os.environ.get("SVTREK_PROC_ID", "0"))
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _DISTRIBUTED_INITIALIZED = True
    return len(jax.devices())


def make_global_array(local: np.ndarray, mesh: Mesh) -> jax.Array:
    """Assemble a process-local block into a global, mesh-sharded array
    (axis 0 sharded across the mesh): each process contributes its own
    rows; XLA addresses only the local shards, so no data moves between
    hosts.  Single-process meshes take the plain device_put path."""
    spec = P(mesh.axis_names[0])
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local, sharding)
    return jax.make_array_from_process_local_data(sharding, local)


def _local_audit_step(ops, lens, pos, n_ops, window_id, kind,
                      inter_start, inter_end, imprecise_pos,
                      *, num_windows_local, K, min_count, interval, range_,
                      sweep_width=128):
    """Per-shard audit step (window ids are shard-local)."""
    wid_c = jnp.clip(window_id, 0, num_windows_local - 1)
    kind_r = jnp.take(kind, wid_c)
    istart_r = jnp.take(inter_start, wid_c)
    iend_r = jnp.take(inter_end, wid_c)
    cand, _ = extract_read_candidates(ops, lens, pos, n_ops, kind_r,
                                      istart_r, iend_r)
    locs, counts, read_ovf = group_candidates_by_window(
        cand, window_id, num_windows_local, K
    )
    refined, sweep_ovf = consensus_pos_batch(
        locs, jnp.minimum(counts, K), imprecise_pos,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )
    return refined, counts, sweep_ovf | read_ovf | (counts > K)


def sharded_audit_step(mesh: Mesh, *, num_windows: int, K: int,
                       min_count: int = C.CONSENSUS_MIN_COUNT,
                       interval: int = C.CONSENSUS_INTERVAL,
                       range_: int = C.CONSENSUS_INTERVAL_RANGE,
                       sweep_width: int = 128):
    """Build the jitted multi-chip audit step for `mesh`.

    Expects batch arrays laid out shard-blockwise: reads axis N and window
    axis B both divisible by the mesh size, window_id *local to its
    shard's block* (padding reads use the local sentinel B//n).
    Returns fn(ops, lens, pos, n_ops, window_id, kind, istart, iend, ipos)
    -> (refined [B], counts [B]).
    """
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    if num_windows % n:
        raise ValueError(f"num_windows {num_windows} not divisible by mesh size {n}")
    b_loc = num_windows // n

    local = functools.partial(
        _local_audit_step,
        num_windows_local=b_loc, K=K,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )
    spec = P(axis)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec,) * 9,
        out_specs=(spec, spec, spec),
    )
    return jax.jit(fn)


def sharded_audit_step_csr(mesh: Mesh, *, num_windows: int, K: int, O: int,
                           min_count: int = C.CONSENSUS_MIN_COUNT,
                           interval: int = C.CONSENSUS_INTERVAL,
                           range_: int = C.CONSENSUS_INTERVAL_RANGE,
                           sweep_width: int = 128):
    """Multi-chip step for the flat (CSR) device-extract layout
    (ops.audit_step.AuditBatchCSR): each shard receives its own block of
    the flat op stream and scatters it into the padded [N_loc, O]
    matrices in its own device memory — the host link still carries only the real
    CIGAR ops (~half the padded bytes), now per shard (VERDICT r2 weak
    7: the CSR step is worth keeping, so it shards).

    Layout contract (pack.pack_chunk_native with n_shards > 1): every
    axis shard-blockwise — flat T, reads N, windows B all divisible by
    the mesh size; window_id shard-local with padding sentinel B_loc;
    per-shard flat tails beyond sum(local n_ops) are unobserved garbage.
    """
    from ..ops.audit_step import csr_to_padded

    n = mesh.devices.size
    axis = mesh.axis_names[0]
    if num_windows % n:
        raise ValueError(
            f"num_windows {num_windows} not divisible by mesh size {n}")
    b_loc = num_windows // n

    def local(ops_flat, lens_flat, pos, n_ops, window_id,
              kind, inter_start, inter_end, imprecise_pos):
        ops, lens = csr_to_padded(ops_flat, lens_flat, n_ops, O=O)
        return _local_audit_step(
            ops, lens, pos, n_ops, window_id,
            kind, inter_start, inter_end, imprecise_pos,
            num_windows_local=b_loc, K=K,
            min_count=min_count, interval=interval, range_=range_,
            sweep_width=sweep_width,
        )

    spec = P(axis)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec,) * 9,
        out_specs=(spec, spec, spec),
    )
    return jax.jit(fn)


def sharded_consensus_step(mesh: Mesh, *, num_windows: int,
                           min_count: int = C.CONSENSUS_MIN_COUNT,
                           interval: int = C.CONSENSUS_INTERVAL,
                           range_: int = C.CONSENSUS_INTERVAL_RANGE,
                           sweep_width: int = 128):
    """Multi-chip step for host-extracted candidate batches
    (pack.AuditBatchCand): shards the window axis of the consensus sweep
    across the mesh.  Rows are independent windows, so the layout is the
    natural blockwise split — no shard-local id remapping needed.

    Returns fn(locs [B, K], counts [B], ipos [B]) -> (refined [B],
    sweep_ovf [B])."""
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    if num_windows % n:
        raise ValueError(
            f"num_windows {num_windows} not divisible by mesh size {n}")

    def local(locs, counts, ipos):
        return consensus_pos_batch(
            locs, counts, ipos,
            min_count=min_count, interval=interval, range_=range_,
            sweep_width=sweep_width,
        )

    spec = P(axis)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec),
    )
    return jax.jit(fn)


def sharded_disc_step(mesh: Mesh, *, min_len: int = 50, cap: int = 512):
    """Multi-chip disc detection: shard the read axis of the projected-
    run scan (ops.discover.scan_projected_runs_compact) across the mesh
    — reads are independent rows, so the split is the natural blockwise
    one with no collectives (VERDICT r2 item 4: disc gets the same
    shard_map treatment as audt's consensus step).

    Returns fn(ops [N, O], lens, n_runs, ref_start) with N divisible by
    the mesh size; padding rows use n_runs == 0 (no real runs, no
    breakpoints).  Outputs are per-shard compact blocks: totals [S],
    rows/types/refs/reads/lens [S * cap] with shard-LOCAL row indices
    (caller adds s * (N/S)); a shard total > cap means the caller must
    rescan on the host."""
    from ..ops.discover import scan_projected_runs_compact

    axis = mesh.axis_names[0]

    def local(ops, lens, n_runs, ref_start):
        total, row, t, ref, read, ln = scan_projected_runs_compact(
            ops, lens, n_runs, ref_start, min_len=min_len, cap=cap)
        return total[None], row, t, ref, read, ln

    spec = P(axis)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec,) * 6,
    )
    return jax.jit(fn)


def make_sharded_demo_batch(num_devices: int, b_per_shard: int = 2,
                            reads_per_window: int = 4, O: int = 16,
                            seed: int = 0):
    """Synthetic shard-blockwise batch for dry runs and scaling tests."""
    rng = np.random.default_rng(seed)
    B = num_devices * b_per_shard
    N = B * reads_per_window
    ops = np.full((N, O), 9, np.int8)
    lens = np.zeros((N, O), np.int32)
    pos = np.zeros(N, np.int32)
    n_ops = np.zeros(N, np.int32)
    wid = np.zeros(N, np.int32)
    kind = np.zeros(B, np.int32)
    istart = np.zeros(B, np.int32)
    iend = np.zeros(B, np.int32)
    ipos = np.zeros(B, np.int32)
    r = 0
    for b in range(B):
        base = int(rng.integers(50_000, 90_000))
        kind[b] = C.KIND_DEL_START
        istart[b] = base - 2000
        iend[b] = base + 2000
        ipos[b] = base
        for _ in range(reads_per_window):
            start = base - int(rng.integers(200, 1200))
            cig = [(0, base - start + int(rng.integers(-2, 3))),
                   (2, 60), (0, 500)]
            ops[r, : len(cig)] = [o for o, _ in cig]
            lens[r, : len(cig)] = [l for _, l in cig]
            pos[r] = start
            n_ops[r] = len(cig)
            wid[r] = b % b_per_shard          # shard-local window id
            r += 1
    return ops, lens, pos, n_ops, wid, kind, istart, iend, ipos
