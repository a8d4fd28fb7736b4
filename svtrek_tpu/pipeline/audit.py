"""`audt` mode driver: VCF + BAM → refined breakpoint records.

Batched re-design of the reference's process_vcf/thread_func pipeline
(audit.c:50-357): instead of a pthread pool pulling VCF lines from a
bounded queue, the host parses + packs fixed-shape window batches and one
jitted XLA program per bucket refines a whole batch at once; results are
emitted deterministically in input order (removing the reference's
unsynchronized-stdout interleaving class of bug; SURVEY.md §5 'race
detection').

The reference's producer-consumer line queue (audit.c:13-48, capacity
tload_factor × threads) survives as a bounded batch queue: a producer
thread does BAM fetch + packing while the device chews the previous
batch, and the driver keeps one device batch in flight (JAX async
dispatch), so host I/O, host packing, and device compute overlap —
the double-buffered input pipeline of SURVEY.md §2's template mapping.

With more than one accelerator visible (or cfg.data_shards set), each
batch is packed shard-blockwise and refined by the shard_map'd multi-chip
step (parallel.mesh.sharded_audit_step) — record-granular data
parallelism over the mesh, the reference's pthread model mapped to the
devices of one host.
"""
from __future__ import annotations

import functools
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from ..config import AudtConfig
from ..constants import SVType
from ..emit import format_result
from ..io.vcf import VcfSkip, VcfTask, iter_vcf_tasks
from ..oracle import refine_task
from ..ops.audit_step import audit_refine_step
from .pack import (
    INT64_MIN, PackedBatch, PackedCandBatch, PackedReads, as_read_list,
    pack_chunk, pack_chunk_cand, pack_chunk_native, windows_for_task,
)

NA32 = 0xFFFFFFFF


@dataclass
class AuditResult:
    task: VcfTask
    rstart: int = NA32
    rend: int = NA32
    emit: bool = True
    chrom_label: object = None  # --chrom-by-name: print the CHROM name
    remaining: int = 0          # windows not yet applied (streaming emit)
    # --ins-consensus: POA consensus of the inserted sequence
    needs_seq: bool = False
    cons_tid: int = -1
    seq: str | None = None      # None = unresolved; "" = no consensus

    def line(self) -> str:
        chrom = (self.chrom_label if self.chrom_label is not None
                 else self.task.chrom_index)
        text = format_result(
            self.task.sv_type, chrom, self.task.pos,
            self.task.end, self.rstart, self.rend,
        )
        if self.needs_seq:
            text += f", seq: {self.seq if self.seq else 'NA'}"
        return text


@dataclass
class AuditStats:
    """Per-stage wall-clock and work counters (real --verbose;
    the reference parses the flag and never reads it, SURVEY.md §5)."""

    parse_s: float = 0.0
    pack_s: float = 0.0      # producer pool: BAM fetch + packing (aggregate worker-seconds)
    device_s: float = 0.0    # blocked on device results
    emit_s: float = 0.0
    cons_s: float = 0.0      # --ins-consensus: seq fetch + POA batches
    cons_sites: int = 0      # INS sites given a consensus sequence
    total_s: float = 0.0
    records: int = 0
    windows: int = 0
    reads: int = 0
    batches: int = 0
    oracle_windows: int = 0  # host-fallback windows, all causes (total)
    fallback_kovf: int = 0   # candidate count exceeded K (cand_width)
    fallback_sweep: int = 0  # consensus sweep exceeded sweep_width
    fallback_long: int = 0   # a read exceeded the top ops bucket
    fallback_device: int = 0 # device-extract overflow (lumped causes)
    data_shards: int = 1

    def report(self, err) -> None:
        from ..parallel.mesh import device_label

        print(
            f"[VERBOSE] records={self.records} windows={self.windows} "
            f"reads={self.reads} batches={self.batches} "
            f"oracle_fallbacks={self.oracle_windows} "
            f"(kovf={self.fallback_kovf} sweep={self.fallback_sweep} "
            f"long_ops={self.fallback_long} device={self.fallback_device}) "
            f"data_shards={self.data_shards} {device_label()}",
            file=err,
        )
        print(
            f"[VERBOSE] parse={self.parse_s:.3f}s "
            f"fetch+pack={self.pack_s:.3f}s device_wait={self.device_s:.3f}s "
            f"emit={self.emit_s:.3f}s total={self.total_s:.3f}s",
            file=err,
        )
        if self.cons_sites:
            print(
                f"[VERBOSE] ins_consensus sites={self.cons_sites} "
                f"time={self.cons_s:.3f}s",
                file=err,
            )


def _next_pow2(n: int, lo: int = 16) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


@functools.lru_cache(maxsize=None)
def _get_sharded_step(n_dev: int, num_windows: int, K: int,
                      min_count: int, interval: int, range_: int,
                      sweep_width: int = 128):
    import jax

    from ..parallel.mesh import make_mesh, sharded_audit_step

    mesh = make_mesh(jax.devices()[:n_dev])
    return sharded_audit_step(
        mesh, num_windows=num_windows, K=K,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )


@functools.lru_cache(maxsize=None)
def _get_sharded_csr(n_dev: int, num_windows: int, K: int, O: int,
                     min_count: int, interval: int, range_: int,
                     sweep_width: int = 128):
    import jax

    from ..parallel.mesh import make_mesh, sharded_audit_step_csr

    mesh = make_mesh(jax.devices()[:n_dev])
    return sharded_audit_step_csr(
        mesh, num_windows=num_windows, K=K, O=O,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )


@functools.lru_cache(maxsize=None)
def _get_sharded_consensus(n_dev: int, num_windows: int,
                           min_count: int, interval: int, range_: int,
                           sweep_width: int):
    import jax

    from ..parallel.mesh import make_mesh, sharded_consensus_step

    mesh = make_mesh(jax.devices()[:n_dev])
    return sharded_consensus_step(
        mesh, num_windows=num_windows,
        min_count=min_count, interval=interval, range_=range_,
        sweep_width=sweep_width,
    )


def resolve_data_shards(cfg) -> int:
    """How many mesh shards to pack for: cfg.data_shards, or (auto) the
    local device count. Import of jax is deferred so pure-host paths
    never initialize a backend.

    When SVTREK_COORDINATOR is exported, the jax.distributed backend is
    bootstrapped first (parallel.mesh.init_distributed) — the multi-host
    launch is the same CLI command on every host plus three env vars."""
    import os as _os

    if _os.environ.get("SVTREK_COORDINATOR"):
        from ..parallel.mesh import init_distributed

        init_distributed()
    n = getattr(cfg, "data_shards", 0)
    if n and n > 0:
        return n
    import jax

    return max(1, jax.local_device_count())


def dispatch_refinement(packed, cfg: AudtConfig):
    """Launch the device step for one packed batch (async dispatch);
    returns the un-materialized device arrays, or None for empty."""
    from ..ops.audit_step import (
        AuditBatchCSR, audit_consensus_step, audit_refine_step_csr,
    )

    b = packed.batch
    if b.num_windows == 0:
        return None
    sweep_width = getattr(cfg, "sweep_width", 128)
    if isinstance(packed, PackedCandBatch):
        if packed.n_shards > 1:
            step = _get_sharded_consensus(
                packed.n_shards, b.num_windows,
                cfg.consensus_min_count, cfg.consensus_interval,
                cfg.consensus_interval_range, sweep_width,
            )
            return step(b.locs, b.counts, b.imprecise_pos)
        return audit_consensus_step(
            b.locs, b.counts, b.imprecise_pos,
            min_count=cfg.consensus_min_count,
            interval=cfg.consensus_interval,
            range_=cfg.consensus_interval_range,
            sweep_width=sweep_width,
        )
    K = _next_pow2(min(cfg.max_candidates, 8192), 64)
    if isinstance(b, AuditBatchCSR):
        if packed.n_shards > 1:
            step = _get_sharded_csr(
                packed.n_shards, b.num_windows, K, b.ops_width,
                cfg.consensus_min_count, cfg.consensus_interval,
                cfg.consensus_interval_range, sweep_width,
            )
            return step(b.ops_flat, b.lens_flat, b.pos, b.n_ops,
                        b.window_id, b.kind, b.inter_start, b.inter_end,
                        b.imprecise_pos)
        return audit_refine_step_csr(
            b.ops_flat, b.lens_flat, b.pos, b.n_ops, b.window_id,
            b.kind, b.inter_start, b.inter_end, b.imprecise_pos,
            num_windows=b.num_windows, K=K, O=b.ops_width,
            min_count=cfg.consensus_min_count,
            interval=cfg.consensus_interval,
            range_=cfg.consensus_interval_range,
            sweep_width=sweep_width,
        )
    if packed.n_shards > 1:
        step = _get_sharded_step(
            packed.n_shards, b.num_windows, K,
            cfg.consensus_min_count, cfg.consensus_interval,
            cfg.consensus_interval_range, sweep_width,
        )
        return step(b.ops, b.lens, b.pos, b.n_ops, b.window_id,
                    b.kind, b.inter_start, b.inter_end, b.imprecise_pos)
    return audit_refine_step(
        b.ops, b.lens, b.pos, b.n_ops, b.window_id,
        b.kind, b.inter_start, b.inter_end, b.imprecise_pos,
        num_windows=b.num_windows, K=K,
        min_count=cfg.consensus_min_count,
        interval=cfg.consensus_interval,
        range_=cfg.consensus_interval_range,
        sweep_width=sweep_width,
    )


def collect_refinement(packed, dev, cfg: AudtConfig,
                       stats: AuditStats | None = None) -> list:
    """Materialize device results (+ oracle fallback). Returns
    (window, refined) pairs."""
    out = []
    if isinstance(packed, PackedCandBatch):
        from ..oracle import consensus_pos

        refined, sweep_ovf = (np.asarray(x) for x in dev)
        for i, w in enumerate(packed.windows):
            if packed.refined_c[i] != INT64_MIN:
                # K overflow: the C extractor already ran the exact
                # scalar consensus over the full candidate set.
                if stats:
                    stats.oracle_windows += 1
                    stats.fallback_kovf += 1
                out.append((w, int(packed.refined_c[i])))
            elif sweep_ovf[i]:
                # Sweep overflow: exact host consensus over the (<= K,
                # already sorted) candidates — no re-fetch needed.
                if stats:
                    stats.oracle_windows += 1
                    stats.fallback_sweep += 1
                cnt = int(packed.true_counts[i])
                r = consensus_pos(
                    packed.batch.locs[i, :cnt].tolist(), w.imprecise_pos,
                    cfg.consensus_min_count, cfg.consensus_interval,
                    cfg.consensus_interval_range,
                )
                out.append((w, r))
            else:
                out.append((w, int(refined[i])))
        return out
    if dev is not None:
        refined, counts, overflow = (np.asarray(x) for x in dev)
        slots = (packed.window_slots if packed.window_slots is not None
                 else range(len(packed.windows)))
        for i, (w, slot) in enumerate(zip(packed.windows, slots)):
            if overflow[slot]:
                # Capacity/sweep overflow: exact host fallback.
                if stats:
                    stats.oracle_windows += 1
                    stats.fallback_device += 1
                r = refine_task(
                    w.kind, as_read_list(packed.reads_per_window[i]),
                    w.inter_start, w.inter_end, w.imprecise_pos,
                    cfg.consensus_min_count, cfg.consensus_interval,
                    cfg.consensus_interval_range,
                )
            else:
                r = int(refined[slot])
            out.append((w, r))
    for w, reads in packed.oracle_windows:
        if stats:
            stats.oracle_windows += 1
            stats.fallback_long += 1
        r = refine_task(
            w.kind, reads, w.inter_start, w.inter_end, w.imprecise_pos,
            cfg.consensus_min_count, cfg.consensus_interval,
            cfg.consensus_interval_range,
        )
        out.append((w, r))
    return out


def run_refinement(packed: PackedBatch, cfg: AudtConfig) -> list:
    """Run one packed batch on device (+ oracle fallback). Returns
    (window, refined) pairs."""
    return collect_refinement(packed, dispatch_refinement(packed, cfg), cfg)


def _resume_state(cfg, err):
    """One streaming scan of the existing output file (--resume):
    returns (n_done, first_line, last_line) or None.  Only the line
    count and the first/last lines are kept — resuming a multi-million-
    line whole-genome output costs O(1) memory."""
    if not (getattr(cfg, "resume", False) and cfg.output_file
            and os.path.exists(cfg.output_file)):
        return None
    n_done, first, last = 0, None, None
    with open(cfg.output_file) as fh:
        for line in fh:
            if line.strip():
                if first is None:
                    first = line.rstrip("\n")
                last = line.rstrip("\n")
                n_done += 1
    return (n_done, first, last) if n_done else None


def _task_prefix(task: VcfTask) -> tuple[str, str]:
    """The record-derived (deterministic) prefix of a result line, in
    both numeric-chrom and --chrom-by-name flavors."""
    num = format_result(task.sv_type, task.chrom_index, task.pos,
                        task.end, NA32, NA32).split(" ref pos:")[0]
    by_name = format_result(task.sv_type, task.chrom_name, task.pos,
                            task.end, NA32, NA32).split(" ref pos:")[0]
    return num, by_name


def _check_resume_identity(task: VcfTask, got_line: str, which: str,
                           cfg, err) -> None:
    """A resumed output line must belong to the record the count says it
    does — its record-derived fields (type/chrom/org pos/org end) are
    deterministic, so a different shard split or an edited VCF aborts
    instead of silently misaligning lines to records (VERDICT r1 item 9;
    r2 hardened from last-line-only to first+last)."""
    got = got_line.split(" ref pos:")[0]
    expect = _task_prefix(task)
    if got not in expect:
        print(
            f"[ERROR] Resume mismatch: {which} line of "
            f"{cfg.output_file} is {got!r} but record "
            f"{task.line_index} of this input/shard would emit "
            f"{expect[0]!r}. The output file belongs to a different "
            f"input or shard split; refusing to resume.",
            file=err,
        )
        raise SystemExit(1)


def _ins_seqs_py(reader, tid, beg, end, min_len, lo, hi) -> list[str]:
    """Pure-Python analog of the native reader's svbam_ins_seqs: decoded
    SEQ substrings of I ops >= min_len whose refine_ins-convention
    reference position (rp advances for every op that is not I and not
    S, the refinement.c:137-139 quirk) lies in [lo, hi]."""
    out: list[str] = []
    for rec in reader.fetch(tid, beg, end):
        if rec.seq == "*":
            continue
        rp = rec.pos
        qpos = 0
        for op, ln in rec.cigar:
            if op == 1 and ln >= min_len and lo <= rp <= hi:
                out.append(rec.seq[qpos:qpos + ln])
            if op not in (1, 4):
                rp += ln
            if op in (0, 1, 4, 7, 8):
                qpos += ln
    return out


def _resolve_ins_consensus(records: list[AuditResult], reader, cfg,
                           stats: AuditStats | None = None) -> None:
    """Attach a POA consensus of the inserted sequence to each refined
    INS record (--ins-consensus: the audt-mode partial-order-alignment
    path, BASELINE.json configs[2] — the capability slot of the
    reference's built-but-unused abPOA submodule, .gitmodules:5-7, and
    the refine_ins evidence walk it extends, refinement.c:278-325).

    Per record: reads overlapping the refined position whose >=50 bp I
    op lands within consensus_interval of it contribute their inserted
    bases (SEQ decode, skipped by the prefix-parse fetch); one batched
    POA call covers all records.  res.seq = "" when no consensus (too
    few/no supporting inserts) — printed as NA."""
    if getattr(cfg, "poa_engine", "star") == "graph":
        from ..ops.poa_graph_batch import (
            consensus_sequence_poa_batch as consensus_sequence_batch,
        )
    else:
        from ..ops.poa_batch import consensus_sequence_batch

    t0 = time.perf_counter()
    interval = cfg.consensus_interval
    min_len = C.SV_MIN_LENGTH
    seq_lists: list[list[str]] = []
    for res in records:
        r = int(C.u32(res.rstart))
        lo, hi = r - interval, r + interval
        if res.cons_tid < 0:
            seq_lists.append([])
            continue
        if hasattr(reader, "ins_seqs"):
            seqs = reader.ins_seqs(res.cons_tid, max(lo, 0), hi + 1,
                                   min_len, lo, hi)
        else:
            seqs = _ins_seqs_py(reader, res.cons_tid, max(lo, 0), hi + 1,
                                min_len, lo, hi)
        seq_lists.append(seqs)
    for res, s in zip(records, consensus_sequence_batch(seq_lists)):
        res.seq = s or ""
        if s and stats:
            stats.cons_sites += 1
    if stats:
        stats.cons_s += time.perf_counter() - t0


def run_audit(cfg: AudtConfig, out=None, err=None,
              collect_lines: bool = True) -> list[str]:
    """Full audt pipeline. Returns the result lines (also written to
    ``out``/output_file); pass ``collect_lines=False`` on whole-genome
    runs to keep memory flat (lines still stream to out/output_file).

    The record stream is fully pipelined (VERDICT r2 item 5): VCF
    parse → window expansion → producer-pool fetch+pack → device →
    ordered emit all run incrementally, so memory is bounded by the
    batches in flight, not the VCF size (the reference also streams,
    audit.c:295-338)."""
    out = out or sys.stdout
    err = err or sys.stderr
    stats = AuditStats()
    t_start = time.perf_counter()

    from ..io.bam import BamReader
    from ..native import native_bam_reader

    def make_fetch():
        """One reader (+ fetch closure) per producer thread — the
        shared-nothing per-thread htslib handle triple of the reference
        (audit.c:270-272), kept because neither BGZF seek state nor the
        native fetch buffers are shareable across threads."""
        reader = None
        if cfg.use_native_io:
            reader = native_bam_reader(cfg.bam_file)
        if reader is None:
            reader = BamReader(cfg.bam_file)
        if hasattr(reader, "fetch_packed"):
            # Native reader fast path: columnar arrays straight into the
            # vectorized packer — no per-op Python objects.
            def fetch(tid, beg, end):
                return PackedReads(
                    *reader.fetch_packed(tid, int(beg), int(end))
                )
        else:
            def fetch(tid, beg, end):
                return [
                    (rec.pos, rec.cigar)
                    for rec in reader.fetch(tid, int(beg), int(end))
                ]
        fetch._reader = reader  # keep the handle alive with the closure
        return fetch

    # Fail fast (bad BAM path) before spinning up the pool.  With
    # --chrom-by-name, keep the reader to resolve CHROM names against
    # the BAM header (the extension over the reference's tid = chrom-1
    # numeric assumption, refinement.c:114; SURVEY.md 'hard parts').
    probe = make_fetch()
    tid_by_name = None
    if getattr(cfg, "chrom_by_name", False):
        reader = probe._reader
        cache: dict[str, int] = {}

        def tid_by_name(name: str) -> int:  # noqa: F811
            if name not in cache:
                if hasattr(reader, "tid_by_name"):
                    cache[name] = reader.tid_by_name(name)
                else:
                    cache[name] = reader.tid_of(name)
            return cache[name]

    print("[INFO] Started processing variation file.", file=out)

    # --ins-consensus: a dedicated main-thread reader for SEQ extraction
    # (the probe reader is shared with the producer's tid lookups, and
    # BGZF cursor state is not thread-safe).
    ins_cons = getattr(cfg, "ins_consensus", False)
    _cons_reader: list = []

    def cons_reader():
        if not _cons_reader:
            _cons_reader.append(make_fetch()._reader)
        return _cons_reader[0]

    from collections import deque

    num_shards = getattr(cfg, "num_shards", 1) or 1
    shard_index = getattr(cfg, "shard_index", 0)
    resume_state = _resume_state(cfg, err)

    # Streaming record state (bounded by batches in flight): `pending`
    # holds kept records in input order with their unapplied window
    # count; the emit frontier below pops completed records as soon as
    # every earlier record has emitted.  Registration happens in the
    # producer thread strictly before the record's windows are packed
    # (the queue put/get pair orders it before any main-thread access).
    pending_records: deque[AuditResult] = deque()
    results: dict[int, AuditResult] = {}
    vcf_rows: dict | None = {} if cfg.refined_vcf else None

    def gen_windows():
        """Producer-thread stream: VCF → shard filter → resume skip →
        window expansion, registering one AuditResult per kept record."""
        skipped = 0
        first_skipped = last_skipped = None
        n_done = resume_state[0] if resume_state else 0
        shard_i = 0
        with open(cfg.vcf_file, "r") as fh:
            it = iter_vcf_tasks(fh)
            while True:
                t_in = time.perf_counter()
                item = next(it, None)
                if item is None:
                    stats.parse_s += time.perf_counter() - t_in
                    break
                if isinstance(item, VcfSkip):
                    if item.message:
                        print(item.message, file=err)
                    stats.parse_s += time.perf_counter() - t_in
                    continue
                # --num-shards/--shard-index: record-level scale-out.
                keep = (shard_i % num_shards) == shard_index
                shard_i += 1
                if not keep:
                    stats.parse_s += time.perf_counter() - t_in
                    continue
                t = item
                wins, emit = windows_for_task(t, cfg)
                if skipped < n_done:
                    # --resume: skip records whose lines already exist.
                    if emit:
                        skipped += 1
                        if first_skipped is None:
                            first_skipped = t
                        last_skipped = t
                        if skipped == n_done:
                            _check_resume_identity(
                                first_skipped, resume_state[1], "first",
                                cfg, err)
                            _check_resume_identity(
                                last_skipped, resume_state[2], "last",
                                cfg, err)
                            print(
                                f"[INFO] Resume: {n_done} result line(s) "
                                f"already in {cfg.output_file}; skipping "
                                f"them.", file=err)
                    stats.parse_s += time.perf_counter() - t_in
                    continue
                stats.records += 1
                stats.windows += len(wins)
                res = AuditResult(t, emit=emit, remaining=len(wins))
                if tid_by_name is not None:
                    tid = tid_by_name(t.chrom_name)
                    res.chrom_label = t.chrom_name
                    if tid < 0:
                        print(f"[ERROR] CHROM {t.chrom_name!r} not in the "
                              f"BAM header; record {t.line_index} refines "
                              f"to NA.", file=err)
                    for w in wins:
                        w.tid = tid
                if ins_cons and t.sv_type == SVType.INS and emit:
                    from .pack import window_tid

                    res.needs_seq = True
                    res.cons_tid = window_tid(wins[0]) if wins else -1
                results[t.line_index] = res
                pending_records.append(res)
                stats.parse_s += time.perf_counter() - t_in
                yield from wins
        if resume_state and skipped < n_done:
            print(
                f"[ERROR] Resume mismatch: {cfg.output_file} has "
                f"{n_done} result line(s) but this input/shard only "
                f"produces {skipped}. Refusing to resume.",
                file=err,
            )
            raise SystemExit(1)

    n_shards = resolve_data_shards(cfg)
    stats.data_shards = n_shards

    # Bounded batch queue: the reference's producer-consumer line queue
    # (audit.c:13-48, capacity tload_factor × threads) become a pool of
    # cfg.thread_number fetch+pack workers — each with a private BAM
    # handle, shared-nothing like the reference's per-thread htslib
    # triples — feeding packed device batches, in order, to this thread,
    # which keeps one device batch in flight (JAX async dispatch).  The
    # C fetch and the numpy scatters release the GIL, so the workers
    # genuinely overlap each other and the device.
    q: queue.Queue = queue.Queue(maxsize=max(2, cfg.tload_factor))
    stats_lock = threading.Lock()

    def producer():
        import itertools
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        tls = threading.local()

        def work(chunk):
            if not hasattr(tls, "fetch"):
                tls.fetch = make_fetch()
            t0 = time.perf_counter()
            reader = getattr(tls.fetch, "_reader", None)
            extract = getattr(cfg, "extract", "auto")
            if extract != "device" and hasattr(reader, "extract_batch"):
                # Host-extract fast path: C does the fetch AND the
                # evidence walk; the device gets K candidates/window.
                pb = pack_chunk_cand(chunk, reader, cfg, n_shards=n_shards)
            elif hasattr(reader, "fetch_batch"):
                # All-in-C fetch + CSR scatter (flat on the host link,
                # padded in HBM); shard-blockwise when a mesh is up.
                pb = pack_chunk_native(chunk, reader, cfg,
                                       n_shards=n_shards)
            else:
                pb = pack_chunk(chunk, tls.fetch, cfg, n_shards=n_shards)
            dt = time.perf_counter() - t0
            with stats_lock:
                stats.pack_s += dt  # aggregate worker-seconds
            return pb

        bw = cfg.batch_windows

        def chunk_stream():
            chunk = []
            for w in gen_windows():
                chunk.append(w)
                if len(chunk) >= bw:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        chunks = chunk_stream()
        n_workers = max(1, cfg.thread_number)
        try:
            with ThreadPoolExecutor(
                n_workers, thread_name_prefix="svtrek-pack"
            ) as ex:
                pending = deque(
                    ex.submit(work, c)
                    for c in itertools.islice(chunks, n_workers + 2)
                )
                while pending:
                    pb = pending.popleft().result()
                    nxt = next(chunks, None)
                    if nxt is not None:
                        pending.append(ex.submit(work, nxt))
                    q.put(pb)  # blocks when full → bounds work in flight
        except BaseException as e:  # surfaced in the consumer loop
            q.put(e)
            return
        q.put(None)

    prod = threading.Thread(target=producer, daemon=True,
                            name="svtrek-pack-producer")
    prod.start()

    # jax.profiler trace of the batch loop (SURVEY.md §5 'tracing':
    # the reference has none; --verbose + this make it real).
    trace_dir = getattr(cfg, "trace_dir", "")
    trace_ctx = None
    if trace_dir:
        import jax.profiler

        trace_ctx = jax.profiler.trace(trace_dir)
        trace_ctx.__enter__()

    # Streamed, input-ordered emit: lines go to `out` (and the output
    # file) as soon as every earlier record has completed — the
    # deterministic-order guarantee of the old end-of-run emit loop,
    # without holding the whole result set (VERDICT r2 item 5).
    lines: list[str] = []
    emitted = 0
    file_out = None
    if cfg.output_file:
        file_out = open(cfg.output_file,
                        "a" if getattr(cfg, "resume", False) else "w")

    def flush_frontier():
        nonlocal emitted
        t0 = time.perf_counter()
        while pending_records and pending_records[0].remaining == 0:
            head = pending_records[0]
            if (head.needs_seq and head.seq is None
                    and C.u32(head.rstart) != NA32):
                # Resolve every completed-but-unemitted INS site in one
                # batched POA call (natural batching: one resolution per
                # collected device batch, not per record).
                batch = [r for r in pending_records
                         if r.remaining == 0 and r.needs_seq
                         and r.seq is None and C.u32(r.rstart) != NA32]
                _resolve_ins_consensus(batch, cons_reader(), cfg, stats)
            res = pending_records.popleft()
            del results[res.task.line_index]
            if not res.emit:
                continue
            if vcf_rows is not None:
                vcf_rows[res.task.line_index] = (res.task, res.rstart,
                                                 res.rend)
            line = res.line()
            emitted += 1
            if collect_lines:
                lines.append(line)
            print(line, file=out)
            if file_out is not None:
                file_out.write(line + "\n")
        stats.emit_s += time.perf_counter() - t0

    def apply(pairs):
        for w, refined in pairs:
            res = results[w.record_index]
            if w.slot == 0:
                res.rstart = C.u32(refined)
            else:
                res.rend = C.u32(refined)
            res.remaining -= 1
        flush_frontier()

    # Keep several batches in flight (JAX async dispatch pipelines them);
    # each collect pays one host↔device sync round-trip, so a deeper
    # window hides that latency behind the following batches' compute.
    from collections import deque

    in_flight: deque = deque()
    depth = max(2, cfg.tload_factor)
    while True:
        packed = q.get()
        if isinstance(packed, BaseException):
            raise packed
        if packed is None:
            break
        in_flight.append((packed, dispatch_refinement(packed, cfg)))
        stats.batches += 1
        stats.reads += (packed.num_reads if isinstance(packed, PackedCandBatch)
                        else packed.batch.num_reads)
        if len(in_flight) > depth:
            t0 = time.perf_counter()
            apply(collect_refinement(*in_flight.popleft(), cfg, stats))
            stats.device_s += time.perf_counter() - t0
    if in_flight:
        # Drain: one device_get for every outstanding batch — a single
        # host↔device transfer burst instead of one sync per batch.
        import jax

        t0 = time.perf_counter()
        packs = [p for p, _ in in_flight]
        devs = jax.device_get([d for _, d in in_flight])
        for p, d in zip(packs, devs):
            apply(collect_refinement(p, d, cfg, stats))
        stats.device_s += time.perf_counter() - t0
    if trace_ctx is not None:
        trace_ctx.__exit__(None, None, None)
        print(f"[INFO] Wrote jax.profiler trace to {trace_dir}", file=err)
    prod.join()

    # Final frontier flush: everything is applied, so all zero-window
    # records (and any tail) drain here.
    flush_frontier()
    if file_out is not None:
        file_out.close()
    if pending_records:
        raise RuntimeError(
            f"{len(pending_records)} record(s) never completed "
            f"(first remaining={pending_records[0].remaining}) — "
            f"window/batch accounting bug")

    print("[INFO] Ended processing variation file", file=out)

    if cfg.refined_vcf:
        from ..io.vcf_writer import write_refined_vcf

        write_refined_vcf(cfg.refined_vcf, cfg.vcf_file, vcf_rows)

    stats.total_s = time.perf_counter() - t_start
    if cfg.verbose:
        stats.report(err)
    return lines
