"""Property tests: vectorized consensus kernels vs the scalar oracle.

The oracle (svtrek_tpu/oracle/refine.py) encodes the reference semantics
(refinement.c:41-101) exactly; the batched kernel must match bit-for-bit
on adversarial random inputs, including tie/early-return cases.
"""
import numpy as np
import pytest

from svtrek_tpu import constants as C
from svtrek_tpu.oracle import consensus_pos, consensus_lengths, lower_bound, upper_bound
from svtrek_tpu.ops.consensus import consensus_pos_batch, consensus_lengths_batch

PAD = C.I32_MAX


def _pack(cases, K):
    B = len(cases)
    locs = np.full((B, K), PAD, np.int32)
    n = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int32)
    for b, (vals, p) in enumerate(cases):
        s = np.sort(np.asarray(vals, np.int64)).astype(np.int32)
        locs[b, : len(s)] = s
        n[b] = len(s)
        pos[b] = p
    return locs, n, pos


def test_bounds_degenerate():
    assert lower_bound([1, 5, 9], 0) == 0
    assert lower_bound([1, 5, 9], 5) == 1
    assert lower_bound([1, 5, 9], 100) == 2
    assert upper_bound([1, 5, 9], 0) == 2      # quirk: no element < 0
    assert upper_bound([1, 5, 9], 2) == 0


def test_consensus_oracle_basics():
    # Tight cluster at 1000 with 3 supporters within interval of pos.
    assert consensus_pos([1000, 1001, 1002], 1001) == 1001
    # Too few supporters.
    assert consensus_pos([1000, 1001], 1000) == -1
    # Cluster out of range (>500 away) is ignored.
    assert consensus_pos([2000, 2001, 2002], 1000) == -1
    assert consensus_pos([], 1000) == -1


@pytest.mark.parametrize("seed", range(8))
def test_consensus_matches_oracle_random(seed):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(64):
        n = int(rng.integers(0, 40))
        center = int(rng.integers(1000, 100000))
        # Mix tight clusters, scattered noise, duplicates.
        vals = []
        for _ in range(n):
            mode = rng.integers(0, 3)
            if mode == 0:
                vals.append(center + int(rng.integers(-4, 5)))
            elif mode == 1:
                vals.append(center + int(rng.integers(-600, 600)))
            else:
                vals.append(center + int(rng.integers(-30, 30)))
        pos = center + int(rng.integers(-100, 100))
        cases.append((vals, pos))

    K = 64
    locs, n, pos = _pack(cases, K)
    got, ovf = consensus_pos_batch(locs, n, pos)
    assert not np.asarray(ovf).any()
    want = np.array(
        [consensus_pos(vals, p) for vals, p in cases], np.int32
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("seed", range(4))
def test_consensus_matches_oracle_nondefault_params(seed):
    rng = np.random.default_rng(100 + seed)
    min_count, interval, range_ = 2, 12, 200
    cases = []
    for _ in range(48):
        n = int(rng.integers(0, 30))
        center = int(rng.integers(500, 50000))
        vals = [center + int(rng.integers(-300, 300)) for _ in range(n)]
        cases.append((vals, center + int(rng.integers(-50, 50))))
    K = 32
    locs, n, pos = _pack(cases, K)
    got, ovf = consensus_pos_batch(
        locs, n, pos, min_count=min_count, interval=interval, range_=range_
    )
    assert not np.asarray(ovf).any()
    got = np.asarray(got)
    want = np.array(
        [
            consensus_pos(v, p, min_count, interval, range_)
            for v, p in cases
        ],
        np.int32,
    )
    np.testing.assert_array_equal(got, want)


def test_consensus_early_return_tiebreak():
    # Two equal-size clusters straddling pos: the left sweep runs first and
    # returns immediately if its candidate lands within the interval.
    vals = [995, 996, 997, 1004, 1005, 1006]
    pos = 1000
    want = consensus_pos(vals, pos)
    locs, n, p = _pack([(vals, pos)], 16)
    got = int(np.asarray(consensus_pos_batch(locs, n, p)[0])[0])
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_sweep_fold_mixed_clusters_matches_oracle(seed):
    """The lax.scan sweep fold over mixed tight/spread clusters: refined
    positions equal the scalar oracle's wherever the sweep window did
    not overflow (overflowed rows are recomputed on the host)."""
    rng = np.random.default_rng(300 + seed)
    cases = []
    for _ in range(40):
        n = int(rng.integers(0, 40))
        center = int(rng.integers(1000, 100000))
        vals = [
            center + int(rng.integers(-600, 600)) if rng.integers(0, 2)
            else center + int(rng.integers(-6, 7))
            for _ in range(n)
        ]
        cases.append((vals, center + int(rng.integers(-100, 100))))
    locs, n, pos = _pack(cases, 64)
    got, ovf = (np.asarray(x) for x in consensus_pos_batch(locs, n, pos))
    for i, (vals, p) in enumerate(cases):
        if not ovf[i]:
            assert got[i] == consensus_pos(vals, p), i


@pytest.mark.parametrize("seed", range(4))
def test_consensus_lengths_matches_oracle(seed):
    rng = np.random.default_rng(200 + seed)
    cases = []
    for _ in range(32):
        n = int(rng.integers(0, 25))
        vals = [int(rng.integers(50, 400)) for _ in range(n)]
        cases.append((vals, 0))
    K = 32
    locs, n, _ = _pack(cases, K)
    got = np.asarray(consensus_lengths_batch(locs, n))
    want = np.array([consensus_lengths(v) for v, _ in cases], np.int32)
    np.testing.assert_array_equal(got, want)


def test_consensus_large_k_chunked():
    """K=8192 (the documented candidate cap) exercises the chunked
    [B, W, K] stats reduces; parity vs the scalar oracle."""
    import numpy as np

    from svtrek_tpu.oracle.refine import consensus_pos

    rng = np.random.default_rng(5)
    B, K = 4, 8192
    locs = np.full((B, K), 0x7FFFFFFF, np.int32)
    n = np.array([5000, 8192, 3, 700], np.int32)
    pos = np.zeros(B, np.int32)
    for b in range(B):
        base = int(rng.integers(100_000, 1_000_000))
        vals = base + rng.integers(-400, 400, n[b])
        locs[b, : n[b]] = np.sort(vals.astype(np.int32))
        pos[b] = base + int(rng.integers(-20, 20))
    got, ovf = (np.asarray(x) for x in consensus_pos_batch(locs, n, pos))
    for b in range(B):
        if ovf[b]:
            continue
        want = consensus_pos(locs[b, : n[b]].tolist(), int(pos[b]))
        assert got[b] == want, b
