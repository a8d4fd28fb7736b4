"""CLI-level tests (VERDICT round-1 item 9): drive cli.main for all
three modes on tiny fixtures, checking flag→config plumbing, output
file writing, -o/stdout duplication, and resume misalignment abort.
"""
from __future__ import annotations

import io
import os

import pytest

from svtrek_tpu import cli
from tests.fixtures import PlantedSV, write_fixture
from tests.fixtures_disc import gaf_line, make_backbone_gfa, write_fastq


@pytest.fixture(scope="module")
def audt_fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_audt")
    svs = [PlantedSV(1, 50_000, 50_400, "DEL", 400),
           PlantedSV(1, 120_000, 120_001, "INS", 120)]
    bam, vcf = write_fixture(str(d), svs, {1: 300_000}, seed=7)
    return str(d), bam, vcf


def test_cli_audt(audt_fixture, capsys, monkeypatch):
    d, bam, vcf = audt_fixture
    out_path = os.path.join(d, "out.txt")
    rc = cli.main(["audt", "-b", bam, "-v", vcf, "-o", out_path,
                   "--verbose", "-t", "2", "--batch-windows", "64",
                   "--cand-width", "64", "--sweep-width", "64"])
    assert rc == 0
    captured = capsys.readouterr()
    assert "(DEL) chr: 1, org pos: 50000" in captured.out
    assert "(INS) chr: 1, org pos: 120000" in captured.out
    assert "[VERBOSE]" in captured.err
    with open(out_path) as fh:
        file_lines = [l.strip() for l in fh if l.strip()]
    assert len(file_lines) == 2
    assert all(l in captured.out for l in file_lines)


def test_cli_audt_flag_roundtrip(audt_fixture, capsys):
    """Every [ext] flag reaches the pipeline without error and the
    device-extract path gives the same records."""
    d, bam, vcf = audt_fixture
    rc = cli.main(["audt", "-b", bam, "-v", vcf,
                   "-o", os.path.join(d, "out2.txt"),
                   "--extract", "device", "--max-candidates", "256",
                   "--wider-interval", "20000", "--median-interval",
                   "10000", "--narrow-interval", "2000",
                   "--consensus-min-count", "3", "--num-shards", "1",
                   "--data-shards", "1"])
    assert rc == 0
    out1 = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("(")]
    assert len(out1) == 2


def test_cli_audt_missing_file(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["audt", "-b", str(tmp_path / "nope.bam"),
                  "-v", str(tmp_path / "nope.vcf")])


def test_cli_resume_mismatch_aborts(audt_fixture, capsys):
    """Resuming onto an output file from a different input must abort
    with a clear error, not silently misalign lines to records."""
    d, bam, vcf = audt_fixture
    out_path = os.path.join(d, "stale.txt")
    with open(out_path, "w") as fh:
        fh.write("(DEL) chr: 9, org pos: 1, org end: 2, ref pos: NA, "
                 "ref end: NA, diff pos: NA, diff end: NA\n")
    with pytest.raises(SystemExit):
        cli.main(["audt", "-b", bam, "-v", vcf, "-o", out_path,
                  "--resume"])
    assert "Resume mismatch" in capsys.readouterr().err


def test_cli_resume_too_many_lines_aborts(audt_fixture, capsys):
    d, bam, vcf = audt_fixture
    out_path = os.path.join(d, "overfull.txt")
    line = ("(INS) chr: 1, org pos: 120000, ref pos: NA\n")
    with open(out_path, "w") as fh:
        fh.write(line * 50)
    with pytest.raises(SystemExit):
        cli.main(["audt", "-b", bam, "-v", vcf, "-o", out_path,
                  "--resume"])
    assert "Refusing to resume" in capsys.readouterr().err


def test_cli_resume_happy_path(audt_fixture, capsys):
    """A real partial file resumes and appends only the missing lines."""
    d, bam, vcf = audt_fixture
    full = os.path.join(d, "full.txt")
    rc = cli.main(["audt", "-b", bam, "-v", vcf, "-o", full])
    assert rc == 0
    capsys.readouterr()
    with open(full) as fh:
        lines = [l for l in fh if l.strip()]
    partial = os.path.join(d, "partial.txt")
    with open(partial, "w") as fh:
        fh.write(lines[0])
    rc = cli.main(["audt", "-b", bam, "-v", vcf, "-o", partial,
                   "--resume"])
    assert rc == 0
    assert "Resume: 1 result line" in capsys.readouterr().err
    with open(partial) as fh:
        assert [l for l in fh if l.strip()] == lines


def test_cli_scan(audt_fixture, capsys):
    d, bam, vcf = audt_fixture
    rc = cli.main(["scan", "-b", bam, "-c", "1", "-s", "115000",
                   "-e", "125000", "--window-size", "1000",
                   "-o", os.path.join(d, "scan.out")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "(SCAN INS) best position:" in out
    assert "INS Discovery in window" in out


def test_cli_disc(tmp_path, capsys):
    gfa = str(tmp_path / "g.gfa")
    seqs = make_backbone_gfa(gfa, [1000, 1000, 1000],
                             alt={(1, 2): (10, 120)})
    gaf = str(tmp_path / "a.gaf")
    fq = str(tmp_path / "r.fq")
    reads, lines = {}, []
    for i in range(4):
        off = 300 + i * 17
        pre = 1000 - off
        name = f"ins{i}"
        lines.append(gaf_line(name, pre + 120 + 400, 0, pre + 120 + 400,
                              ">1>10>2", 2120, off, off + pre + 120 + 400,
                              f"{pre}=120={400}="))
        reads[name] = seqs[1][off:] + seqs[10] + seqs[2][:400]
    with open(gaf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    write_fastq(fq, reads)
    rc = cli.main(["disc", "-r", gfa, "-a", gaf, "-q", fq,
                   "-o", str(tmp_path / "d.out")])
    assert rc == 0
    assert "DISC INS" in capsys.readouterr().out


def test_cli_scan_chrom_by_name_requires_flag(audt_fixture, capsys):
    d, bam, vcf = audt_fixture
    rc = cli.main(["scan", "-b", bam, "-c", "chr1", "-s", "115000",
                   "-e", "125000"])
    assert rc == 1
    assert "not numeric" in capsys.readouterr().err


def test_cli_scan_chrom_by_name(audt_fixture, capsys):
    d, bam, vcf = audt_fixture
    rc = cli.main(["scan", "-b", bam, "-c", "chr1", "--chrom-by-name",
                   "-s", "115000", "-e", "125000", "--window-size",
                   "1000", "-o", os.path.join(d, "scan_name.out")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "(SCAN INS) best position:" in out
    assert "best position: -1" not in out


def _disc_inputs(tmp_path):
    gfa = str(tmp_path / "g.gfa")
    seqs = make_backbone_gfa(gfa, [1000, 1000, 1000],
                             alt={(1, 2): (10, 120)})
    gaf = str(tmp_path / "a.gaf")
    fq = str(tmp_path / "r.fq")
    reads, lines = {}, []
    for i in range(4):
        off = 300 + i * 17
        pre = 1000 - off
        name = f"ins{i}"
        lines.append(gaf_line(name, pre + 120 + 400, 0, pre + 120 + 400,
                              ">1>10>2", 2120, off, off + pre + 120 + 400,
                              f"{pre}=120={400}="))
        reads[name] = seqs[1][off:] + seqs[10] + seqs[2][:400]
    with open(gaf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    write_fastq(fq, reads)
    return gfa, gaf, fq


def test_cli_disc_resume_checkpoint(tmp_path, capsys):
    """--resume checkpoints the detection phase; a rerun restores it
    (and an input change invalidates the checkpoint)."""
    gfa, gaf, fq = _disc_inputs(tmp_path)
    out = str(tmp_path / "d.out")
    args = ["disc", "-r", gfa, "-a", gaf, "-q", fq, "-o", out, "--resume"]
    assert cli.main(args) == 0
    first = capsys.readouterr().out
    assert os.path.exists(out + ".ckpt.npz")
    with open(out) as fh:
        lines1 = fh.read()

    assert cli.main(args) == 0
    cap = capsys.readouterr()
    assert "Resume:" in cap.err and "skipping GFA/GAF" in cap.err
    with open(out) as fh:
        assert fh.read() == lines1
    assert [l for l in cap.out.splitlines() if l.startswith("(DISC")] == \
        [l for l in first.splitlines() if l.startswith("(DISC")]

    # Touching the GAF invalidates the checkpoint -> full reparse.
    with open(gaf, "a") as fh:
        fh.write("")
    os.utime(gaf, (1, 1))
    assert cli.main(args) == 0
    assert "Resume:" not in capsys.readouterr().err


def test_cli_new_flag_plumbing(tmp_path):
    """Round-4 flags reach the configs: --ins-consensus, --poa-engine
    (audt + disc), --cluster-window (parser-level check)."""
    ap = cli.build_parser()
    a = ap.parse_args(["audt", "-b", "x.bam", "-v", "x.vcf",
                       "--ins-consensus", "--poa-engine", "graph"])
    assert a.ins_consensus and a.poa_engine == "graph"
    d = ap.parse_args(["disc", "-r", "g", "-a", "a", "-q", "q",
                       "--cluster-window", "250", "--poa-engine", "graph"])
    assert d.cluster_window == 250 and d.poa_engine == "graph"


def test_cli_disc_poa_engine_runs(tmp_path, capsys):
    gfa, gaf, fq = _disc_inputs(tmp_path)
    out = str(tmp_path / "pg.out")
    assert cli.main(["disc", "-r", gfa, "-a", gaf, "-q", fq, "-o", out,
                     "--poa-engine", "graph"]) == 0
    star = str(tmp_path / "ps.out")
    assert cli.main(["disc", "-r", gfa, "-a", gaf, "-q", fq,
                     "-o", star]) == 0
    # identical supporting inserts: both engines emit the same consensus
    with open(out) as fh1, open(star) as fh2:
        assert fh1.read() == fh2.read()
