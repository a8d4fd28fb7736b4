#!/usr/bin/env python
"""Whole-genome soak (VERDICT round-1 item 10): >=100k records across
multiple chromosomes through run_audit, exercising --num-shards
sharded runs with exact merge parity against an unsharded run, a
--resume interruption, peak RSS, and the jit recompile count.

Usage: python tools/soak.py [--records N] [--shards S] [--keep]
Prints one JSON line with the measurements (recorded in PARITY.md).
"""
from __future__ import annotations

import argparse
import io
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from svtrek_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from svtrek_tpu.config import AudtConfig  # noqa: E402
from svtrek_tpu.constants import CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S  # noqa: E402
from svtrek_tpu.io.bam import BamRecord, BamWriter  # noqa: E402
from svtrek_tpu.pipeline.audit import run_audit  # noqa: E402

N_CHROM = 4


def n_chroms(n_records: int) -> int:
    """Enough chromosomes that each stays under the BAI binning cap
    (2^29 = 512 Mb; 25 kb spacing × per-chrom records + slack).  Real
    chromosomes respect the same bound (chr1 is 249 Mb)."""
    return max(N_CHROM, (n_records * 25_000) // 500_000_000 + 1)


def build_fixture(tmpdir: str, n_records: int, depth: int = 8,
                  seed: int = 0):
    rng = np.random.default_rng(seed)
    N_CHROM = n_chroms(n_records)
    per_chrom = n_records // N_CHROM
    chrom_len = per_chrom * 25_000 + 200_000
    bam = os.path.join(tmpdir, "soak.bam")
    vcf = os.path.join(tmpdir, "soak.vcf")
    refs = [(str(c + 1), chrom_len) for c in range(N_CHROM)]

    svs = []  # (chrom 1-based, pos, type, len)
    for c in range(N_CHROM):
        pos = 60_000
        for i in range(per_chrom):
            svtype = ("DEL", "INS", "INV")[(c + i) % 3]
            svlen = int(rng.integers(60, 400))
            svs.append((c + 1, pos, svtype, svlen))
            pos += 25_000

    t0 = time.perf_counter()
    op_of = {"DEL": CIGAR_D, "INS": CIGAR_I}
    with BamWriter(bam, refs) as w:
        cur_chrom = 0
        reads = []

        def flush():
            reads.sort()
            for k, (s, cig) in enumerate(reads):
                # seq stays empty ('*'): the audit path reads only
                # pos+CIGAR (like the reference's refine kernels), and
                # nibble-encoding 10 kb dummy sequences would dominate
                # the fixture build at 100k records.
                w.write(BamRecord(name=f"r{cur_chrom}_{k}", flag=0,
                                  tid=cur_chrom, pos=s, mapq=60,
                                  cigar=cig, seq=""))
            reads.clear()

        for chrom, pos, svtype, svlen in svs:
            if chrom - 1 != cur_chrom:
                flush()
                cur_chrom = chrom - 1
            for _ in range(depth):
                start0 = (pos - 1) - int(rng.integers(2_000, 8_000))
                lead = (pos - 1) - start0 + int(rng.integers(-2, 3))
                cig = []
                if rng.random() < 0.25:
                    cig.append((CIGAR_S, int(rng.integers(20, 200))))
                cig.append((CIGAR_M, max(lead, 1)))
                svop = op_of.get(svtype)
                if svop is not None:
                    cig.append((svop, svlen))
                for _ in range(int(rng.integers(4, 10))):
                    cig.append((CIGAR_M, int(rng.integers(50, 400))))
                reads.append((start0, cig))
        flush()
    fixture_s = time.perf_counter() - t0

    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i, (chrom, pos, svtype, svlen) in enumerate(svs):
            end = pos + (svlen if svtype != "INS" else 0)
            fh.write(f"{chrom}\t{pos}\tsv{i}\tN\t<{svtype}>\t.\tPASS\t"
                     f"SVTYPE={svtype};END={end}\n")
    return bam, vcf, fixture_s, len(svs)


def jit_cache_sizes() -> int:
    """Total compiled-variant count across the framework's jitted steps
    (recompile telemetry)."""
    import svtrek_tpu.ops.audit_step as a
    import svtrek_tpu.ops.consensus as c
    import svtrek_tpu.ops.window_scan as wsc

    total = 0
    for mod in (a, c, wsc):
        for name in dir(mod):
            fn = getattr(mod, name)
            if hasattr(fn, "_cache_size"):
                total += fn._cache_size()
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=100_000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--rss-only", action="store_true",
                    help="one streaming unsharded pass (collect_lines="
                         "False, lines to /dev/null); report peak RSS + "
                         "records/s.  Run at 100k and 1M: near-equal "
                         "peaks demonstrate the VERDICT r3 item-5 "
                         "flat-memory claim.  Use --dir to separate "
                         "fixtures so each scale builds once.")
    ap.add_argument("--dir", default="/tmp/svtrek_soak")
    args = ap.parse_args()

    tmpdir = args.dir
    os.makedirs(tmpdir, exist_ok=True)
    marker = os.path.join(tmpdir, f"done_{args.records}")
    bam = os.path.join(tmpdir, "soak.bam")
    vcf = os.path.join(tmpdir, "soak.vcf")
    if args.keep and os.path.exists(marker):
        nc = n_chroms(args.records)
        fixture_s, n_sv = 0.0, args.records // nc * nc
    else:
        bam, vcf, fixture_s, n_sv = build_fixture(tmpdir, args.records)
        open(marker, "w").close()
    print(f"[soak] fixture: {n_sv} records, {fixture_s:.1f}s",
          file=sys.stderr)

    if args.rss_only:
        # Peak RSS so far = fixture build + imports; report it apart so
        # the pipeline's own ceiling is visible.
        rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        cfg = AudtConfig(bam_file=bam, vcf_file=vcf)
        with open(os.devnull, "w") as devnull:
            t0 = time.perf_counter()
            run_audit(cfg, out=devnull, err=sys.stderr,
                      collect_lines=False)
            full_s = time.perf_counter() - t0
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        print(json.dumps({
            "records": n_sv,
            "unsharded_s": round(full_s, 2),
            "unsharded_records_per_sec": round(n_sv / full_s, 1),
            "peak_rss_mb": round(peak, 1),
            "rss_before_run_mb": round(rss_before, 1),
            "jit_variants": jit_cache_sizes(),
            "fixture_s": round(fixture_s, 1),
        }))
        return

    # 1. Unsharded reference run (one warm-up first so the timed run
    #    measures the pipeline, not a cold XLA compile).
    cfg = AudtConfig(bam_file=bam, vcf_file=vcf, verbose=False)
    run_audit(AudtConfig(bam_file=bam, vcf_file=vcf, num_shards=64,
                         shard_index=0),
              out=io.StringIO(), err=sys.stderr)
    t0 = time.perf_counter()
    full = run_audit(cfg, out=io.StringIO(), err=sys.stderr)
    full_s = time.perf_counter() - t0

    # 2. Sharded runs (record-level, like independent jobs) + merge.
    t0 = time.perf_counter()
    shard_lines: list[list[str]] = []
    for s in range(args.shards):
        scfg = AudtConfig(bam_file=bam, vcf_file=vcf,
                          num_shards=args.shards, shard_index=s)
        shard_lines.append(run_audit(scfg, out=io.StringIO(),
                                     err=sys.stderr))
    shard_s = time.perf_counter() - t0
    merged: list[str] = []
    idx = [0] * args.shards
    for i in range(len(full)):
        s = i % args.shards
        merged.append(shard_lines[s][idx[s]])
        idx[s] += 1
    merge_ok = merged == full

    # 3. Resume interruption on shard 0: keep 40% of its output, resume,
    #    compare to the uninterrupted shard run.
    out_path = os.path.join(tmpdir, "resume0.txt")
    keep = len(shard_lines[0]) * 2 // 5
    with open(out_path, "w") as fh:
        fh.write("\n".join(shard_lines[0][:keep]) + "\n")
    rcfg = AudtConfig(bam_file=bam, vcf_file=vcf, num_shards=args.shards,
                      shard_index=0, resume=True, output_file=out_path)
    resumed_tail = run_audit(rcfg, out=io.StringIO(), err=sys.stderr)
    resume_ok = shard_lines[0][:keep] + resumed_tail == shard_lines[0]

    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(json.dumps({
        "records": len(full),
        "unsharded_s": round(full_s, 2),
        "unsharded_records_per_sec": round(len(full) / full_s, 1),
        "sharded_s": round(shard_s, 2),
        "merge_parity": merge_ok,
        "resume_parity": resume_ok,
        "peak_rss_mb": round(peak_rss_mb, 1),
        "jit_variants": jit_cache_sizes(),
        "fixture_s": round(fixture_s, 1),
    }))
    if not (merge_ok and resume_ok):
        sys.exit(1)


if __name__ == "__main__":
    main()
