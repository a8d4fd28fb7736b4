"""Multi-process jax.distributed test (VERDICT round-1 item 3).

Launches 2 subprocess workers on the CPU backend (4 virtual devices
each), each initializing jax.distributed against a local coordinator and
running sharded_consensus_step over the GLOBAL 8-device mesh; asserts
the assembled multi-process result equals the single-process device
result row for row.

This is the multi-host communication backend of SURVEY.md §5 — the
replacement for the reference's single-node pthread parallelism
(audit.c:269-293) across hosts: same CLI on every host with
SVTREK_COORDINATOR/SVTREK_NUM_PROCS/SVTREK_PROC_ID exported.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _expected():
    """The same deterministic problem the workers build (seed 7)."""
    B, K = 16, 32
    rng = np.random.default_rng(7)
    base = rng.integers(10_000, 1_000_000, B).astype(np.int64)
    counts = rng.integers(0, K + 1, B).astype(np.int32)
    locs = np.full((B, K), 0x7FFFFFFF, np.int32)
    for i in range(B):
        v = np.sort((base[i] + rng.integers(-400, 401, counts[i]))
                    .astype(np.int32))
        locs[i, : counts[i]] = v
    ipos = base.astype(np.int32)
    from svtrek_tpu.ops.consensus import consensus_pos_batch

    refined, ovf = consensus_pos_batch(locs, counts, ipos)
    return np.asarray(refined), np.asarray(ovf)


@pytest.fixture(scope="module")
def worker_data(tmp_path_factory):
    """Run the 2 distributed workers ONCE; both tests consume the
    dumped results (consensus rows + disc rows)."""
    tmp_path = tmp_path_factory.mktemp("dist")
    coord = f"127.0.0.1:{_free_port()}"
    outs = [tmp_path / f"w{i}.json" for i in range(2)]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(i), str(outs[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        logs.append((p.returncode, so, se))
    for rc, so, se in logs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{so}\nstderr:\n{se}"
    return [json.loads(out.read_text()) for out in outs]


def test_two_process_distributed_consensus(worker_data):
    rows = {}
    for data in worker_data:
        for idx, val, ovf in data["rows"]:
            rows[idx] = (val, ovf)
    assert len(rows) == 16, sorted(rows)

    refined, ovf = _expected()
    for i in range(16):
        assert rows[i][0] == int(refined[i]), (i, rows[i], int(refined[i]))
        assert rows[i][1] == int(ovf[i])


def test_two_process_distributed_disc(worker_data):
    """sharded_disc_step across 2 real processes / 8 global devices:
    the assembled breakpoint rows equal the single-process device scan
    row for row (VERDICT r3 item 8)."""
    from distributed_worker import build_disc_problem

    from svtrek_tpu.ops.discover import scan_projected_runs_compact

    got = sorted(tuple(r) for data in worker_data
                 for r in data["disc_rows"])

    ops, lens, n_runs, ref_start = build_disc_problem()
    total, rows, types, refs, reads, lns = (
        np.asarray(x) for x in scan_projected_runs_compact(
            ops, lens, n_runs, ref_start, min_len=50, cap=64))
    n = int(total)
    want = sorted(
        (int(rows[k]), int(types[k]), int(refs[k]), int(reads[k]),
         int(lns[k]))
        for k in range(n))
    assert want, "fixture planted no signals"
    assert got == want
