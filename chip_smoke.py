#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU: `audt`, `scan` and `disc`
through the CLI (``svtrek_tpu.cli.main``), in one process, at realistic
sizes, each output compared exactly with a plain reference.

    python chip_smoke.py                # one card: phases 0-5
    python chip_smoke.py --four-cards   # four cards: sharded audt + disc

Phases (one JSON line each):

0. device: a GPU is required (any other platform exits non-zero before
   any result is printed); the card's name and power limit; the native
   C library builds and loads.
1. audt, host-extract (CLI defaults) on a seeded long-read fixture
   (tools/bench_e2e.py: 1,000 DEL/INS/INV records, depth 20 + 10 noise
   reads, 800 CIGAR ops per read), byte-equal to the scalar oracle
   (svtrek_tpu/oracle) driven over the same BAM.  Cold, warm and
   cache-reload runs, with compile seconds and fallback counts.
2. audt --extract device: byte-equal to phase 1.
3. audt --ins-consensus: refined positions equal phase 1; the POA batch
   shapes; the POA DP on the card equal to the scalar banded_align_ins
   on every pair of the bench shape and on a sample of each of the
   phase's own batches; --poa-engine graph on a subset.
4. scan over 20 Mb of the phase-1 BAM: byte-equal to the scalar oracle.
5. disc on 100,000 seeded reads (tools/bench_disc.py): byte-equal to the
   all-host path (no device run scan).

With --four-cards only phases 1, 2 and 5 run, each at --data-shards 4
and 1 (byte-equal) and against its reference, plus a check that every
shard of a sharded step lives on its own card.

The last line is {"ok": true, "device": {"platform", "kind", "count"}};
any mismatch raises, and the script exits non-zero without that line.
Fixtures are cached under <checkout>/.smoke/, keyed by their parameters.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    audt_records=1000, audt_depth=20, audt_ops=800,
    scan_end=20_000_000,
    disc_reads=100_000,
    poa_bench=(256, 1024, 64),     # pairs, target length, band (bench.py)
    graph_records=60,
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CompileClock:
    """Compile seconds and persistent-cache hits, from jax.monitoring."""

    def __init__(self):
        import jax.monitoring as mon

        self.secs = 0.0
        self.hits = 0
        self.misses = 0
        mon.register_event_duration_secs_listener(self._duration)
        mon.register_event_listener(self._event)

    def _duration(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.secs += duration

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def snapshot(self):
        return (self.secs, self.hits, self.misses)

    def since(self, snap):
        return dict(compile_s=round(self.secs - snap[0], 3),
                    cache_hits=self.hits - snap[1],
                    cache_misses=self.misses - snap[2])


def run_cli(argv, clock) -> dict:
    """cli.main in this process, stdout/stderr captured; returns wall
    seconds, compile accounting and the captured stderr."""
    from svtrek_tpu import cli

    out, err = io.StringIO(), io.StringIO()
    snap = clock.snapshot()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {argv} -> rc {rc}:\n{err.getvalue()[-2000:]}")
    return dict(wall_s=round(wall, 3), err=err.getvalue(), **clock.since(snap))


def read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def assert_same(got: str, want: str, what: str) -> None:
    """Exact text equality; the message names the first differing line."""
    if got == want:
        return
    g, w = got.splitlines(), want.splitlines()
    for i, (a, b) in enumerate(zip(g, w)):
        if a != b:
            raise AssertionError(
                f"{what}: line {i + 1} differs:\n  got:  {a!r}\n  want: {b!r}")
    raise AssertionError(f"{what}: {len(g)} lines, want {len(w)}")


def fallbacks(err: str) -> dict:
    m = re.search(r"oracle_fallbacks=(\d+) \(kovf=(\d+) sweep=(\d+) "
                  r"long_ops=(\d+) device=(\d+)\)", err)
    if not m:
        raise AssertionError("no [VERBOSE] stats line")
    return dict(zip(("total", "kovf", "sweep", "long_ops", "device"),
                    map(int, m.groups())))


def cons_seconds(err: str) -> float | None:
    m = re.search(r"ins_consensus sites=\d+ time=([0-9.]+)s", err)
    return float(m.group(1)) if m else None


# -- references ---------------------------------------------------------

def _native_fetch(bam):
    from svtrek_tpu.native import native_bam_reader
    from svtrek_tpu.pipeline.pack import PackedReads

    reader = native_bam_reader(bam)
    if reader is None:
        raise RuntimeError("native BAM reader unavailable")

    def fetch(tid, beg, end):
        return PackedReads(*reader.fetch_packed(tid, int(beg), int(end)))

    return fetch


def oracle_audit_text(bam: str, vcf: str) -> str:
    """audt output as the scalar oracle computes it, window by window
    (the reads come from the native reader's fetch)."""
    from svtrek_tpu import constants as C
    from svtrek_tpu.config import AudtConfig
    from svtrek_tpu.emit import format_result
    from svtrek_tpu.io.vcf import VcfSkip, iter_vcf_tasks
    from svtrek_tpu.oracle import refine_task
    from svtrek_tpu.pipeline.pack import (
        as_read_list, query_region, windows_for_task,
    )

    cfg = AudtConfig(bam_file=bam, vcf_file=vcf)
    fetch = _native_fetch(bam)
    lines = []
    with open(vcf) as fh:
        for task in iter_vcf_tasks(fh):
            if isinstance(task, VcfSkip):
                continue
            wins, emit_ = windows_for_task(task, cfg)
            if not emit_:
                continue
            res = [0xFFFFFFFF, 0xFFFFFFFF]
            for w in wins:
                reads = ([] if w.kind == C.KIND_POINT
                         else as_read_list(query_region(fetch, w)))
                res[w.slot] = C.u32(refine_task(
                    w.kind, reads, w.inter_start, w.inter_end,
                    w.imprecise_pos, cfg.consensus_min_count,
                    cfg.consensus_interval, cfg.consensus_interval_range))
            lines.append(format_result(task.sv_type, task.chrom_index,
                                       task.pos, task.end, *res))
    return "".join(f"{x}\n" for x in lines)


def oracle_scan_text(bam: str, chrom: int, start: int, end: int) -> str:
    """scan output as the scalar oracle computes it, tile by tile."""
    from svtrek_tpu import constants as C
    from svtrek_tpu.config import ScanConfig
    from svtrek_tpu.oracle import extract_candidates, window_scan
    from svtrek_tpu.pipeline.scan import scan_tiles

    cfg = ScanConfig(bam_file=bam, chrom=chrom, start=start, end=end)
    fetch = _native_fetch(bam)
    lines = []
    best, support = -1, 0
    for s, e in scan_tiles(cfg):
        reads = fetch(chrom - 1, C.u32(s - 1), C.u32(e - 1)).to_list()
        bp, sup = window_scan(
            extract_candidates(C.KIND_INS, reads, s, e),
            cfg.consensus_min_count, cfg.window_size, cfg.slide_size)
        if bp != -1:
            lines.append(f"INS Discovery in window [{s}, {e}] at position "
                         f"{bp} with support {sup}")
            if sup > support:
                best, support = bp, sup
    lines.append(f"(SCAN INS) best position: {best}, support: {support}")
    return "\n".join(lines) + "\n"


@contextlib.contextmanager
def record_poa_batches(store: dict):
    """Record each POA batch's (B, M, N, W) and its first input."""
    from svtrek_tpu.ops import poa_batch

    saved = poa_batch._dp_cols_batch

    def wrapped(tpad, ms, qpad, ns, bands, *, W):
        key = (tpad.shape[0], tpad.shape[1], qpad.shape[1], W)
        store.setdefault(key, (tpad, ms, qpad, ns, bands, W))
        return saved(tpad, ms, qpad, ns, bands, W=W)

    poa_batch._dp_cols_batch = wrapped
    try:
        yield
    finally:
        poa_batch._dp_cols_batch = saved


def _load_test_module(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_smoke_{name}", os.path.join(HERE, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- fixtures -----------------------------------------------------------

def _cached(tag: str, build) -> str:
    d = os.path.join(HERE, ".smoke", tag)
    if not os.path.exists(os.path.join(d, "done")):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        build(d)
        open(os.path.join(d, "done"), "w").close()
    return d


def audt_fixture(sizes) -> tuple[str, str, float]:
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from bench_e2e import build_fixture

    r, dp, o = sizes["audt_records"], sizes["audt_depth"], sizes["audt_ops"]
    t0 = time.perf_counter()
    d = _cached(f"audt_r{r}_d{dp}_o{o}_seed0", lambda d: build_fixture(
        d, r, dp, o, seed=0, realistic_seq=True))
    return (os.path.join(d, "bench.bam"), os.path.join(d, "bench.vcf"),
            time.perf_counter() - t0)


def disc_fixture(sizes) -> tuple[dict, float]:
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from bench_disc import build_fixture

    n = sizes["disc_reads"]
    t0 = time.perf_counter()
    d = _cached(f"disc_n{n}_seed0", lambda d: build_fixture(d, n, seed=0))
    return ({k: os.path.join(d, f"bench.{k}") for k in ("gfa", "gaf", "fq")},
            time.perf_counter() - t0)


# -- phases ---------------------------------------------------------------

def phase_device() -> dict:
    import jax

    devs = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    from svtrek_tpu.native.build import build
    from svtrek_tpu.native.bamlib import load_library

    t0 = time.perf_counter()
    if build() is None or load_library() is None:
        raise RuntimeError("native C library did not build or load")
    return dict(phase="0_device", platform=devs[0].platform,
                device_kind=devs[0].device_kind, count=len(devs),
                nvidia_smi=smi.splitlines(),
                native_build_s=round(time.perf_counter() - t0, 3))


def phase_audt_host(bam, vcf, work, clock, fixture_s, sizes) -> tuple[dict, str]:
    import jax

    out = os.path.join(work, "audt_host.out")
    argv = ["audt", "-b", bam, "-v", vcf, "-o", out, "--verbose"]
    cold = run_cli(argv, clock)
    text = read(out)
    warm = run_cli(argv, clock)
    assert_same(read(out), text, "audt warm vs cold")
    jax.clear_caches()            # drop in-memory executables: the next
    reload = run_cli(argv, clock)  # run compiles from the disk cache
    assert_same(read(out), text, "audt reload vs cold")
    t0 = time.perf_counter()
    assert_same(text, oracle_audit_text(bam, vcf), "audt vs oracle")
    n = text.count("\n")
    return dict(
        phase="1_audt_host", records=n, fixture_s=round(fixture_s, 3),
        sizes={k: sizes[k] for k in ("audt_records", "audt_depth",
                                     "audt_ops")},
        records_per_s_warm=round(n / warm["wall_s"], 1),
        cold={k: v for k, v in cold.items() if k != "err"},
        warm={k: v for k, v in warm.items() if k != "err"},
        cache_reload={k: v for k, v in reload.items() if k != "err"},
        fallbacks=fallbacks(warm["err"]),
        reference="scalar oracle", reference_s=round(time.perf_counter() - t0, 3),
        equal=True), text


def phase_audt_device(bam, vcf, work, clock, want: str) -> dict:
    out = os.path.join(work, "audt_device.out")
    argv = ["audt", "-b", bam, "-v", vcf, "-o", out, "--verbose",
            "--extract", "device"]
    cold = run_cli(argv, clock)
    assert_same(read(out), want, "audt --extract device vs phase 1")
    warm = run_cli(argv, clock)
    assert_same(read(out), want, "audt --extract device (warm) vs phase 1")
    n = want.count("\n")
    return dict(phase="2_audt_device", records=n,
                records_per_s_warm=round(n / warm["wall_s"], 1),
                cold_s=cold["wall_s"], compile_s=cold["compile_s"],
                fallbacks=fallbacks(warm["err"]), equal_phase1=True)


def _strip_seq(text: str) -> str:
    return re.sub(r", seq: [^\n]*", "", text)


def poa_vs_scalar(t_poa, tp, ms, qp, ns, bands, W, rows) -> None:
    """The XLA POA DP on the card against the scalar anchor on the given
    rows of one padded batch."""
    from svtrek_tpu.ops.poa_batch import _dp_cols_batch

    cols, ins = (np.asarray(x) for x in _dp_cols_batch(
        tp, ms, qp, ns, bands, W=W))
    t_poa.assert_matches_scalar(
        cols[rows], ins[rows], ms[rows], bands[rows],
        [tp[i, : ms[i]] for i in rows], [qp[i, : ns[i]] for i in rows])


def phase_ins_consensus(bam, vcf, work, clock, want: str, sizes) -> dict:
    from svtrek_tpu.ops.poa_batch import UNROLL, _nbucket

    t_poa = _load_test_module("test_poa_dp")
    out = os.path.join(work, "audt_inscons.out")
    argv = ["audt", "-b", bam, "-v", vcf, "-o", out, "--verbose",
            "--ins-consensus"]
    shapes: dict = {}
    with record_poa_batches(shapes):
        cold = run_cli(argv, clock)
    text = read(out)
    assert_same(_strip_seq(text), want, "--ins-consensus positions vs phase 1")
    n_seq = len(re.findall(r", seq: [ACGTN]", text))
    assert n_seq > 0, "no INS consensus produced"
    warm = run_cli(argv, clock)
    assert_same(read(out), text, "--ins-consensus warm vs cold")

    # The POA DP on the card against the scalar anchor: the CPU test
    # bodies, every pair of the bench shape, and a sample of each batch
    # this phase produced.
    t0 = time.perf_counter()
    for case in t_poa.PARITY_CASES:
        t_poa.test_xla_matches_scalar(*case, UNROLL)
    t_poa.test_xla_degenerate_pairs(UNROLL)
    t_poa.test_dispatch_matches_scalar_anchor()
    B, M, band = sizes["poa_bench"]
    tp, ms, qp, ns, bands, W, _, _ = t_poa.make_pairs(
        np.random.default_rng(0), B, M, band, sub=0.05, ins=0.02, dele=0.02,
        jitter=1, bucket=_nbucket)
    poa_vs_scalar(t_poa, tp, ms, qp, ns, bands, W, np.arange(B))
    checked = [dict(B=B, M=tp.shape[1], N=qp.shape[1], W=W, pairs=B)]
    for key, (tp, ms, qp, ns, bands, W) in sorted(shapes.items()):
        rows = np.unique(np.linspace(0, len(ms) - 1, 32).astype(int))
        poa_vs_scalar(t_poa, tp, ms, qp, ns, bands, W, rows)
        checked.append(dict(zip("BMNW", key), pairs=len(rows)))
    poa_check_s = time.perf_counter() - t0

    # --poa-engine graph on the first records.
    sub_vcf = os.path.join(work, "subset.vcf")
    with open(vcf) as src, open(sub_vcf, "w") as dst:
        kept = 0
        for line in src:
            if not line.startswith("#"):
                if kept == sizes["graph_records"]:
                    break
                kept += 1
            dst.write(line)
    out_g = os.path.join(work, "audt_graph.out")
    graph = run_cli(["audt", "-b", bam, "-v", sub_vcf, "-o", out_g,
                     "--ins-consensus", "--poa-engine", "graph"], clock)
    got_g = _strip_seq(read(out_g))
    assert_same(got_g, "".join(want.splitlines(True)[:got_g.count("\n")]),
                "--poa-engine graph positions vs phase 1")
    return dict(
        phase="3_ins_consensus", records=text.count("\n"),
        ins_with_seq=n_seq,
        poa_batches=[dict(B=b, M=m, N=nn, W=w)
                     for b, m, nn, w in sorted(shapes)],
        cold_s=cold["wall_s"], compile_s=cold["compile_s"],
        warm_s=warm["wall_s"], poa_stage_warm_s=cons_seconds(warm["err"]),
        poa_vs_scalar_checked=checked, poa_check_s=round(poa_check_s, 3),
        graph_records=sizes["graph_records"], graph_s=graph["wall_s"],
        equal_phase1=True)


def phase_scan(bam, work, clock, sizes) -> dict:
    out = os.path.join(work, "scan.out")
    end = sizes["scan_end"]
    argv = ["scan", "-b", bam, "-c", "1", "-s", "1", "-e", str(end),
            "-o", out]
    cold = run_cli(argv, clock)
    text = read(out)
    warm = run_cli(argv, clock)
    assert_same(read(out), text, "scan warm vs cold")
    t0 = time.perf_counter()
    assert_same(text, oracle_scan_text(bam, 1, 1, end), "scan vs oracle")
    tiles = -(-(end - 1) // 1000)
    return dict(phase="4_scan", span_bp=end - 1, tiles=tiles,
                lines=text.count("\n"), cold_s=cold["wall_s"],
                compile_s=cold["compile_s"],
                windows_per_s_warm=round(tiles / warm["wall_s"], 1),
                reference="scalar oracle",
                reference_s=round(time.perf_counter() - t0, 3), equal=True)


def disc_reference(paths) -> str:
    from svtrek_tpu.config import DiscConfig
    from svtrek_tpu.pipeline.discover import run_discover

    cfg = DiscConfig(gfa_file=paths["gfa"], gaf_file=paths["gaf"],
                     fq_file=paths["fq"], use_device_scan=False)
    lines = run_discover(cfg, out=io.StringIO(), err=io.StringIO())
    return "".join(f"{x}\n" for x in lines)


def phase_disc(paths, work, clock, sizes, fixture_s) -> dict:
    out = os.path.join(work, "disc.out")
    argv = ["disc", "-r", paths["gfa"], "-a", paths["gaf"], "-q",
            paths["fq"], "-o", out]
    cold = run_cli(argv, clock)
    text = read(out)
    warm = run_cli(argv, clock)
    assert_same(read(out), text, "disc warm vs cold")
    t0 = time.perf_counter()
    assert_same(text, disc_reference(paths), "disc vs all-host path")
    n = sizes["disc_reads"]
    return dict(phase="5_disc", reads=n, clusters=text.count("\n"),
                fixture_s=round(fixture_s, 3), cold_s=cold["wall_s"],
                compile_s=cold["compile_s"], warm_s=warm["wall_s"],
                reads_per_s_warm=round(n / warm["wall_s"], 1),
                reference="all-host disc",
                reference_s=round(time.perf_counter() - t0, 3), equal=True)


def check_shard_placement(n: int) -> dict:
    """Each shard of a sharded step's input and output lives on its own
    card."""
    import jax

    from svtrek_tpu.parallel.mesh import (
        make_global_array, make_mesh, sharded_consensus_step,
    )

    mesh = make_mesh(jax.devices()[:n])
    B, K = 8 * n, 64
    locs = np.full((B, K), 0x7FFFFFFF, np.int32)
    locs[:, :5] = np.arange(1000, 1005, dtype=np.int32)
    counts = np.full(B, 5, np.int32)
    ipos = np.full(B, 1002, np.int32)
    args = [make_global_array(x, mesh) for x in (locs, counts, ipos)]
    refined, _ = sharded_consensus_step(mesh, num_windows=B)(*args)
    want = sorted(d.id for d in mesh.devices.flat)
    for arr in (args[0], refined):
        shards = arr.addressable_shards
        devs = sorted(s.device.id for s in shards)
        assert devs == want, (devs, want)
        assert all(s.data.shape[0] == B // n for s in shards)
    assert (np.asarray(refined) == 1002).all()
    return dict(phase="shard_placement", devices=want, rows_per_card=B // n)


def smoke(sizes: dict, four_cards: bool) -> None:
    clock = CompileClock()
    work = os.path.join(HERE, ".smoke", "out")
    os.makedirs(work, exist_ok=True)
    if not four_cards:
        bam, vcf, fx = audt_fixture(sizes)
        p1, want = phase_audt_host(bam, vcf, work, clock, fx, sizes)
        emit(p1)
        emit(phase_audt_device(bam, vcf, work, clock, want))
        emit(phase_ins_consensus(bam, vcf, work, clock, want, sizes))
        emit(phase_scan(bam, work, clock, sizes))
        paths, fx = disc_fixture(sizes)
        emit(phase_disc(paths, work, clock, sizes, fx))
        return
    emit(check_shard_placement(4))
    bam, vcf, fx = audt_fixture(sizes)
    want = oracle_audit_text(bam, vcf)
    for extract in ("host", "device"):
        got = {}
        for shards in (4, 1):
            out = os.path.join(work, f"audt_{extract}_{shards}.out")
            r = run_cli(["audt", "-b", bam, "-v", vcf, "-o", out,
                         "--verbose", "--extract", extract,
                         "--data-shards", str(shards)], clock)
            assert f"data_shards={shards} " in r["err"]
            got[shards] = read(out)
            got[f"{shards}_wall_s"] = r["wall_s"]
        assert_same(got[4], got[1], f"audt {extract}: 4 shards vs 1")
        assert_same(got[4], want, f"audt {extract}: 4 shards vs oracle")
        emit(dict(phase=f"audt_{extract}_4cards", records=want.count("\n"),
                  wall_s_4_shards=got["4_wall_s"],
                  wall_s_1_shard=got["1_wall_s"], equal=True))
    paths, fx = disc_fixture(sizes)
    got = {}
    for shards in (4, 1):
        out = os.path.join(work, f"disc_{shards}.out")
        r = run_cli(["disc", "-r", paths["gfa"], "-a", paths["gaf"], "-q",
                     paths["fq"], "-o", out, "--data-shards", str(shards)],
                    clock)
        got[shards], got[f"{shards}_wall_s"] = read(out), r["wall_s"]
    assert_same(got[4], got[1], "disc: 4 shards vs 1")
    assert_same(got[4], disc_reference(paths), "disc: 4 shards vs all-host")
    emit(dict(phase="disc_4cards", reads=sizes["disc_reads"],
              clusters=got[4].count("\n"), wall_s_4_shards=got["4_wall_s"],
              wall_s_1_shard=got["1_wall_s"], equal=True))


def result_line(devs) -> dict:
    """The last line: success and the device as JAX reports it."""
    return {"ok": True, "device": {"platform": devs[0].platform,
                                   "kind": devs[0].device_kind,
                                   "count": len(devs)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded audt/disc phases on four cards")
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(HERE, "svtrek_tpu", "cli.py")):
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from svtrek_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    devs = jax.devices()
    want = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) != want:
        print(f"chip_smoke.py: needs {want} GPU(s); JAX reports "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    emit(phase_device())
    smoke(FULL, args.four_cards)
    emit(dict(phase="done", wall_s=round(time.perf_counter() - t0, 3)))
    emit(result_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
