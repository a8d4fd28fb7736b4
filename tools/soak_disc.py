#!/usr/bin/env python
"""disc-mode streaming soak (VERDICT r3 item 4: disc scale + failure
parity with audt's soak story).

Builds a large synthetic pangenome (tools/bench_disc.py fixture shape:
noisy ~80-runs/kb GAF alignments, planted clustered INS/DEL/clip
signals, FASTQ) and runs the full disc pipeline — C GAF parse +
projection → batched device scan → clustering → POA consensus —
measuring wall time, reads/s, peak RSS, and cluster count; then
exercises the checkpoint/resume path (detection restored from
<output>.ckpt.npz, consensus recomputed) and asserts line equality
with the from-scratch run.

Usage: python tools/soak_disc.py [--reads N] [--keep]
Prints one JSON line (recorded in PARITY.md).  The fixture is cached in
/tmp/svtrek_soak_disc_<N>; run twice for a clean-process RSS number
(first run pays fixture generation inside the same process).
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from svtrek_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    from bench_disc import build_fixture

    from svtrek_tpu.config import DiscConfig
    from svtrek_tpu.pipeline.discover import run_discover

    tmpdir = f"/tmp/svtrek_soak_disc_{args.reads}"
    os.makedirs(tmpdir, exist_ok=True)
    marker = os.path.join(tmpdir, "done")
    if not os.path.exists(marker):
        t0 = time.perf_counter()
        build_fixture(tmpdir, args.reads)
        open(marker, "w").close()
        print(f"[soak_disc] fixture built in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    paths = {k: os.path.join(tmpdir, f"bench.{e}")
             for k, e in (("gfa_file", "gfa"), ("gaf_file", "gaf"),
                          ("fq_file", "fq"))}
    out_file = os.path.join(tmpdir, "soak.out")

    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

    cfg = DiscConfig(**paths, output_file=out_file)
    t0 = time.perf_counter()
    lines = run_discover(cfg, out=io.StringIO(), err=io.StringIO())
    wall = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

    # Resume: the detection checkpoint (written unconditionally above)
    # restores the expensive phase; output must be identical.
    rcfg = DiscConfig(**paths, output_file=out_file, resume=True)
    t0 = time.perf_counter()
    rlines = run_discover(rcfg, out=io.StringIO(), err=io.StringIO())
    resume_wall = time.perf_counter() - t0
    assert rlines == lines, "resume output differs from scratch run"

    gaf_mb = os.path.getsize(paths["gaf_file"]) / 1e6
    print(json.dumps({
        "reads": args.reads,
        "wall_s": round(wall, 2),
        "reads_per_sec": round(args.reads / wall, 1),
        "gaf_mb": round(gaf_mb, 1),
        "clusters": len(lines),
        "peak_rss_mb": round(peak, 1),
        "rss_before_run_mb": round(rss_before, 1),
        "resume_wall_s": round(resume_wall, 2),
        "resume_equal": True,
    }))

    if not args.keep:
        os.unlink(out_file)


if __name__ == "__main__":
    main()
