"""`disc` mode driver: GFA + GAF + FASTQ → discovered SVs.

The completed form of the reference's WIP discover() path
(discover.c:409-443; SURVEY.md §3.3): project every read's graph
alignment onto the rank-0 backbone, scan for >=50 bp INS/DEL/clip signals
(batched device kernel), cluster signals across reads, and for insertion
clusters extract the inserted read substrings and build a consensus
sequence (the abPOA-shaped step the reference never implemented —
SURVEY.md §2.14).

Defined output (the reference defines none):
  (DISC DEL) ref pos: P, len: L, support: N
  (DISC INS) ref pos: P, len: L, support: N, seq: <consensus or NA>
  (DISC CLIP) ref pos: P, len: L, support: N
positions are 0-based backbone coordinates; one line per cluster with
support >= consensus_min_count, sorted by (type, position).
"""
from __future__ import annotations

import functools
import hashlib
import os
import sys
from dataclasses import dataclass, field

import numpy as np

from ..config import DiscConfig
from ..io.fastq import iter_fastq, reverse_complement
from ..io.gaf import Breakpoint, iter_gaf
from ..io.gfa import parse_gfa
from ..ops.discover import (
    BP_CLIP, BP_DEL, BP_INS, scan_projected_runs_compact,
)

_TYPE_NAME = {BP_INS: "INS", BP_DEL: "DEL", BP_CLIP: "CLIP"}
_RUN_BUCKETS = (32, 128, 512, 2048, 8192)


@dataclass
class SvCluster:
    type: str
    ref_pos: int
    length: int
    support: int
    members: list[Breakpoint] = field(default_factory=list)
    seq: str | None = None

    def line(self) -> str:
        base = (
            f"(DISC {self.type}) ref pos: {self.ref_pos}, "
            f"len: {self.length}, support: {self.support}"
        )
        if self.type == "INS":
            base += f", seq: {self.seq if self.seq else 'NA'}"
        return base


def _bucket(n: int) -> int:
    for b in _RUN_BUCKETS:
        if n <= b:
            return b
    return _RUN_BUCKETS[-1]


def _flat_bucket(total: int, lo: int = 1 << 16) -> int:
    """pow2 bucket for the flat CSR run stream length (recompile
    control: one jit variant per (T, O) pair)."""
    v = lo
    while v < total:
        v *= 2
    return v


_BP_CAP = 2048  # compact-kernel capacity (overflow → exact host rescan)


@functools.lru_cache(maxsize=None)
def _get_sharded_disc(n_dev: int, min_len: int):
    import jax

    from ..parallel.mesh import make_mesh, sharded_disc_step

    mesh = make_mesh(jax.devices()[:n_dev])
    return sharded_disc_step(mesh, min_len=min_len,
                             cap=max(256, _BP_CAP // n_dev))


class _DeviceScanner:
    """Shared async dispatch/collect window for the batched device scan.

    The device scans batch k while the host parses/projects k+1..k+d;
    each collect's host↔device sync round-trip hides behind later
    batches' parse instead of serializing.  `meta` per
    dispatch maps padded row indices back to read identity and carries
    the exact-rescan fallback for compact-kernel overflow."""

    DEPTH = 3

    def __init__(self, min_len: int, n_shards: int, out: list):
        from collections import deque

        self.min_len = min_len
        self.n_shards = max(n_shards, 1)
        self.out = out
        self.step = (_get_sharded_disc(n_shards, min_len)
                     if n_shards > 1 else None)
        self.in_flight = deque()

    def dispatch(self, ops, lens, n_runs, ref_start, meta):
        if self.step is not None:
            dev = self.step(ops, lens, n_runs, ref_start)
        else:
            dev = scan_projected_runs_compact(
                ops, lens, n_runs, ref_start, min_len=self.min_len,
                cap=_BP_CAP,
            )
        self.in_flight.append((meta, ops.shape[0] // self.n_shards, dev))
        if len(self.in_flight) > self.DEPTH:
            self._collect(self.in_flight.popleft())

    def dispatch_csr(self, ops_flat, lens_flat, n_runs, ref_start, O,
                     meta):
        """Flat-CSR dispatch (single-device): ~2.5x fewer bytes up the
        host link than the padded form; device-side scatter."""
        from ..ops.discover import scan_projected_runs_compact_csr

        dev = scan_projected_runs_compact_csr(
            ops_flat, lens_flat, n_runs, ref_start, O=O,
            min_len=self.min_len, cap=_BP_CAP,
        )
        self.in_flight.append((meta, n_runs.shape[0], dev))
        if len(self.in_flight) > self.DEPTH:
            self._collect(self.in_flight.popleft())

    def drain(self):
        while self.in_flight:
            self._collect(self.in_flight.popleft())

    def _emit(self, meta, row_off, rows, types, refs, reads_pos, lns, n):
        name_of, rc_of, _ = meta
        for i in range(n):
            r = row_off + int(rows[i])
            self.out.append(Breakpoint(
                name_of(r), _TYPE_NAME[int(types[i])],
                int(refs[i]), int(reads_pos[i]), int(lns[i]), rc_of(r),
            ))

    def _collect(self, item):
        import jax

        meta, n_loc, dev = item
        res = [np.asarray(x) for x in jax.device_get(dev)]
        rescan = meta[2]
        if self.step is not None:
            totals, rows, types, refs, rpos, lns = res
            S = totals.shape[0]
            cap = rows.shape[0] // S
            if (totals > cap).any():
                # Rare overflow: exact host rescan of the whole batch.
                self.out.extend(rescan())
                return
            for s in range(S):
                n = int(totals[s])
                sl = slice(s * cap, s * cap + n)
                self._emit(meta, s * n_loc, rows[sl], types[sl],
                           refs[sl], rpos[sl], lns[sl], n)
        else:
            total, rows, types, refs, rpos, lns = res
            total = int(total)
            if total > rows.shape[0]:
                self.out.extend(rescan())
                return
            self._emit(meta, 0, rows, types, refs, rpos, lns, total)


def detect_breakpoints(projected, min_len: int, batch_reads: int = 512,
                       n_shards: int = 1, device: bool = True):
    """Batched device scan over projected reads → Breakpoint list.

    Reads whose run count exceeds the largest bucket fall back to the
    host scalar scan (identical semantics).  With ``n_shards > 1`` the
    read axis is shard_map'd across the mesh (reads are independent, so
    the split is collective-free — mesh.sharded_disc_step).
    ``device=False`` runs everything through the host scalar scan (the
    bench baseline; must agree exactly with the device kernel)."""
    from ..io.gaf import scan_breakpoints

    if not device:
        out: list[Breakpoint] = []
        for p in projected:
            out.extend(scan_breakpoints(p, min_len))
        return out

    out: list[Breakpoint] = []
    batch: list = []
    scanner = _DeviceScanner(min_len, n_shards, out)
    n_shards = scanner.n_shards

    def flush():
        nonlocal batch
        if not batch:
            return
        reads = batch
        O = _bucket(max(len(p.runs) for p in reads))
        # Stable read axis (one compiled variant per O bucket): pad the
        # tail batch up to the full batch size, and to the shard count.
        N = max(len(reads), batch_reads)
        if N % n_shards:
            N += n_shards - N % n_shards
        ops = np.full((N, O), 9, np.int8)
        lens = np.zeros((N, O), np.int32)
        n_runs = np.zeros(N, np.int32)   # padding rows: 0 runs, no signal
        ref_start = np.zeros(N, np.int32)
        # One flat scatter for the whole batch (per-read np.asarray
        # loops cost more than the device step at 100k+ reads).
        n_runs[: len(reads)] = np.fromiter(
            (len(p.runs) for p in reads), np.int32, len(reads))
        ref_start[: len(reads)] = np.fromiter(
            (p.reference_start for p in reads), np.int64, len(reads)
        ).astype(np.int32)
        cnt = n_runs[: len(reads)]
        total = int(cnt.sum(dtype=np.int64))
        if total:
            # fromiter beats np.array(list-of-tuples) ~5x at this volume
            flat_ops = np.fromiter(
                (o for p in reads for o, _ in p.runs), np.int8, total)
            flat_lens = np.fromiter(
                (l for p in reads for _, l in p.runs), np.int32, total)
            rows = np.repeat(np.arange(len(reads), dtype=np.int64), cnt)
            starts = np.cumsum(cnt, dtype=np.int64) - cnt
            cols = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
            ops[rows, cols] = flat_ops
            lens[rows, cols] = flat_lens

        def rescan(reads=reads):
            bps = []
            for p in reads:
                bps.extend(scan_breakpoints(p, min_len))
            return bps

        meta = (lambda r, reads=reads: reads[r].read_name,
                lambda r, reads=reads: reads[r].rc,
                rescan)
        scanner.dispatch(ops, lens, n_runs, ref_start, meta)
        batch = []

    for p in projected:
        if len(p.runs) > _RUN_BUCKETS[-1]:
            out.extend(scan_breakpoints(p, min_len))
            continue
        batch.append(p)
        if len(batch) >= batch_reads:
            flush()
    flush()
    scanner.drain()
    return out


def _scan_csr_rows(b, rows, min_len: int) -> list[Breakpoint]:
    """Exact host scalar scan of native-batch rows (fallback paths)."""
    from ..io.gaf import ProjectedRead, scan_breakpoints

    out: list[Breakpoint] = []
    for i in rows:
        i = int(i)
        pr = ProjectedRead(
            read_name=b.name(i), read_len=int(b.read_len[i]),
            read_start=int(b.read_start[i]), read_end=int(b.read_end[i]),
            rc=bool(b.rc[i]), reference_start=int(b.ref_start[i]),
            runs=b.runs(i),
        )
        out.extend(scan_breakpoints(pr, min_len))
    return out


def detect_breakpoints_native(reader, min_len: int, batch_reads: int = 8192,
                              n_shards: int = 1) -> list[Breakpoint]:
    """Device scan fed by the C GAF fast path (io/gaf_native.py).

    Each CSR batch from the native tokenizer/projector scatters straight
    into the padded device layout with vectorized numpy — no per-read
    Python objects anywhere on this path (the GAF analog of the native
    BAM reader's packed-fetch design; VERDICT r3 missing #2)."""
    out: list[Breakpoint] = []
    scanner = _DeviceScanner(min_len, n_shards, out)
    n_shards = scanner.n_shards

    while (b := reader.next_batch(batch_reads)) is not None:
        big = b.n_runs > _RUN_BUCKETS[-1]
        if big.any():
            out.extend(_scan_csr_rows(b, np.nonzero(big)[0], min_len))
            keep = np.nonzero(~big)[0]
        else:
            keep = None
        n_keep = b.n if keep is None else len(keep)
        if n_keep == 0:
            continue
        counts = b.n_runs if keep is None else b.n_runs[keep]
        O = _bucket(int(counts.max()) if n_keep else 1)
        N = max(n_keep, batch_reads)
        if N % n_shards:
            N += n_shards - N % n_shards
        n_runs = np.zeros(N, np.int32)
        ref_start = np.zeros(N, np.int32)
        n_runs[:n_keep] = counts
        rs = b.ref_start if keep is None else b.ref_start[keep]
        ref_start[:n_keep] = rs.astype(np.int32)
        total = int(counts.sum(dtype=np.int64))
        flat_ops = flat_lens = None
        if total:
            starts_in = np.cumsum(counts, dtype=np.int64) - counts
            if keep is None:
                # CSR is hole-free: flat arrays ARE the concatenation.
                flat_ops, flat_lens = b.flat_ops, b.flat_lens
            else:
                idx = (np.repeat(b.run_off[keep], counts)
                       + np.arange(total, dtype=np.int64)
                       - np.repeat(starts_in, counts))
                flat_ops = b.flat_ops[idx]
                flat_lens = b.flat_lens[idx]

        def _map(r, keep=keep):
            return r if keep is None else int(keep[r])

        def rescan(b=b, keep=keep):
            return _scan_csr_rows(
                b, range(b.n) if keep is None else keep, min_len)

        meta = (lambda r, b=b, m=_map: b.name(m(r)),
                lambda r, b=b, m=_map: bool(b.rc[m(r)]),
                rescan)
        if scanner.step is None:
            # Single-device path: ship the flat CSR arrays (the padded
            # [N, O] form is ~2.5x the bytes at typical 45-run reads);
            # the device scatters into the padded layout itself.
            T = _flat_bucket(total)
            of = np.zeros(T, np.int8)
            lf = np.zeros(T, np.int32)
            if total:
                of[:total] = flat_ops
                lf[:total] = flat_lens
            scanner.dispatch_csr(of, lf, n_runs, ref_start, O, meta)
        else:
            ops = np.full((N, O), 9, np.int8)
            lens = np.zeros((N, O), np.int32)
            if total:
                rows = np.repeat(np.arange(n_keep, dtype=np.int64),
                                 counts)
                cols = (np.arange(total, dtype=np.int64)
                        - np.repeat(starts_in, counts))
                ops[rows, cols] = flat_ops
                lens[rows, cols] = flat_lens
            scanner.dispatch(ops, lens, n_runs, ref_start, meta)
    scanner.drain()
    return out


def cluster_breakpoints(
    bps: list[Breakpoint],
    min_count: int,
    cluster_window: int = 100,
) -> list[SvCluster]:
    """Greedy position clustering per type: sorted signals chain into one
    cluster while each consecutive gap is <= ``cluster_window`` (a dense
    signal trail can therefore span more than cluster_window end to end —
    single-linkage, not distance-to-mean); clusters with support >=
    min_count survive.  Position/length are rounded means (the
    (total + n/2)/n convention of refinement.c:65)."""
    clusters: list[SvCluster] = []
    for t in ("INS", "DEL", "CLIP"):
        sel = sorted(
            (b for b in bps if b.type == t), key=lambda b: (b.ref_pos, b.length)
        )
        cur: list[Breakpoint] = []

        def close():
            if len(cur) >= min_count:
                n = len(cur)
                pos = (sum(b.ref_pos for b in cur) + n // 2) // n
                ln = (sum(b.length for b in cur) + n // 2) // n
                clusters.append(SvCluster(t, pos, ln, n, list(cur)))

        for b in sel:
            if cur and b.ref_pos - cur[-1].ref_pos > cluster_window:
                close()
                cur = []
            cur.append(b)
        if cur:
            close()
    clusters.sort(key=lambda c: (c.type, c.ref_pos))
    return clusters


def consensus_insert_sequences(
    clusters: list[SvCluster], fq_path: str, engine: str = "star"
) -> None:
    """Attach a consensus inserted sequence to each INS cluster.

    Fills the reference's TODO at discover.c:401 (abPOA was built but
    never wired, SURVEY.md §2.14): extract each supporting read's
    inserted substring (reverse-complement-normalized) and run the POA
    consensus kernel over them.
    """
    wanted: dict[str, list[tuple[SvCluster, Breakpoint]]] = {}
    for c in clusters:
        if c.type != "INS":
            continue
        for b in c.members:
            wanted.setdefault(b.read_name, []).append((c, b))
    if not wanted:
        return

    per_cluster: dict[int, list[str]] = {}
    for name, seq in iter_fastq(fq_path, names=wanted):
        hits = wanted.get(name)
        if not hits:
            continue
        for c, b in hits:
            s = reverse_complement(seq) if b.rc else seq
            sub = s[b.read_pos : b.read_pos + b.length]
            if sub:
                per_cluster.setdefault(id(c), []).append(sub)

    if engine == "graph":
        from ..ops.poa_graph_batch import (
            consensus_sequence_poa_batch as consensus_batch,
        )
    else:
        from ..ops.poa_batch import (
            consensus_sequence_batch as consensus_batch,
        )

    ins = [c for c in clusters if c.type == "INS"]
    seq_lists = [per_cluster.get(id(c), []) for c in ins]
    for c, s in zip(ins, consensus_batch(seq_lists)):
        if s:
            c.seq = s


def _ckpt_key(cfg: DiscConfig) -> str:
    """Input-identity key for the detection checkpoint: GFA/GAF path +
    size + mtime + the detection parameter.  A different input or
    min-length invalidates the checkpoint instead of silently reusing
    stale breakpoints (same refusal discipline as audt's resume identity
    check, pipeline/audit.py)."""
    h = hashlib.sha256()
    for p in (cfg.gfa_file, cfg.gaf_file):
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
    h.update(f"minlen={cfg.sv_min_length}".encode())
    return h.hexdigest()[:16]


def _ckpt_path(cfg: DiscConfig) -> str:
    return (cfg.output_file or "svtrek.disc") + ".ckpt.npz"


def _save_ckpt(cfg: DiscConfig, bps: list[Breakpoint]) -> None:
    np.savez_compressed(
        _ckpt_path(cfg),
        key=np.array(_ckpt_key(cfg)),
        read_name=np.array([b.read_name for b in bps], dtype=object),
        type=np.array([b.type for b in bps], dtype=object),
        ref_pos=np.array([b.ref_pos for b in bps], np.int64),
        read_pos=np.array([b.read_pos for b in bps], np.int64),
        length=np.array([b.length for b in bps], np.int64),
        rc=np.array([b.rc for b in bps], bool),
    )


def _load_ckpt(cfg: DiscConfig) -> list[Breakpoint] | None:
    path = _ckpt_path(cfg)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=True) as z:
        if str(z["key"]) != _ckpt_key(cfg):
            return None
        return [
            Breakpoint(str(n), str(t), int(rp), int(qp), int(ln), bool(rc))
            for n, t, rp, qp, ln, rc in zip(
                z["read_name"], z["type"], z["ref_pos"],
                z["read_pos"], z["length"], z["rc"],
            )
        ]


def run_discover(cfg: DiscConfig, out=None, err=None) -> list[str]:
    out = out or sys.stdout
    err = err or sys.stderr

    print("[INFO] Started graph discovery.", file=out)
    bps = _load_ckpt(cfg) if getattr(cfg, "resume", False) else None
    if bps is not None:
        print(f"[INFO] Resume: {len(bps)} breakpoint(s) restored from "
              f"{_ckpt_path(cfg)}; skipping GFA/GAF projection.", file=err)
    else:
        from .audit import resolve_data_shards

        n_shards = resolve_data_shards(cfg)
        gfa = parse_gfa(cfg.gfa_file)
        errors: list[str] = []
        reader = None
        if (getattr(cfg, "use_native_parse", True)
                and getattr(cfg, "use_device_scan", True)):
            try:
                from ..io.gaf_native import NativeGafReader

                reader = NativeGafReader(cfg.gaf_file, gfa)
            except OSError:
                reader = None   # no native lib: Python parse path
        if reader is not None:
            try:
                bps = detect_breakpoints_native(
                    reader, cfg.sv_min_length, cfg.batch_reads,
                    n_shards=n_shards)
                errors = reader.errors
            finally:
                reader.close()
        else:
            projected = iter_gaf(cfg.gaf_file, gfa, errors)
            bps = detect_breakpoints(projected, cfg.sv_min_length,
                                     cfg.batch_reads, n_shards=n_shards,
                                     device=getattr(cfg, "use_device_scan",
                                                    True))
        for name in errors:
            print(f"[ERROR] Read {name} has an invalid path.", file=err)
        # Checkpoint the expensive phase (projection + device scan)
        # unconditionally — a crash during the consensus pass must leave
        # something to resume even when --resume wasn't passed on the
        # first run (VERDICT r3).  Gated on output_file only so library
        # callers without one don't get surprise files in cwd; the CLI
        # always sets it.
        if cfg.output_file or getattr(cfg, "resume", False):
            _save_ckpt(cfg, bps)

    clusters = cluster_breakpoints(bps, cfg.consensus_min_count,
                                   getattr(cfg, "cluster_window", 100))
    consensus_insert_sequences(clusters, cfg.fq_file,
                               getattr(cfg, "poa_engine", "star"))

    # Stream result lines to the output file as they are finalized
    # (VERDICT r2: disc's output was one non-streamed join; audt and
    # scan both stream).
    file_out = None
    if cfg.output_file:
        file_out = open(cfg.output_file, "w")
    lines = []
    try:
        for c in clusters:
            line = c.line()
            lines.append(line)
            print(line, file=out)
            if file_out is not None:
                file_out.write(line + "\n")
                file_out.flush()
    finally:
        if file_out is not None:
            file_out.close()
    print("[INFO] Ended graph discovery.", file=out)
    return lines
