"""Property tests: the batched device DP (ops/poa_batch.py) must
reproduce the scalar semantic anchor (ops/poa.py) bit-for-bit."""
import numpy as np
import pytest

from svtrek_tpu.ops.poa import banded_align, consensus_sequence, encode
from svtrek_tpu.ops.poa_batch import (
    banded_cols_batch, consensus_sequence_batch,
)

BASES = "ACGT"


def _mutate(rng, seq, sub=0.05, ins=0.02, dele=0.02):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(BASES[rng.integers(4)])
        else:
            out.append(c)
        if rng.random() < ins:
            out.append(BASES[rng.integers(4)])
    return "".join(out)


def _rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def test_banded_cols_matches_scalar():
    rng = np.random.default_rng(7)
    targets, queries = [], []
    for _ in range(40):
        m = int(rng.integers(5, 220))
        t = _rand_seq(rng, m)
        q = _mutate(rng, t, sub=0.1, ins=0.05, dele=0.05)
        targets.append(encode(t))
        queries.append(encode(q if q else "A"))
    # unrelated pairs + extreme length mismatch (band forced wide)
    for m, n in [(8, 200), (200, 8), (3, 3), (1, 40)]:
        targets.append(encode(_rand_seq(rng, m)))
        queries.append(encode(_rand_seq(rng, n)))
    got_cols, got_segs = banded_cols_batch(targets, queries, band=16)
    from svtrek_tpu.ops.poa import banded_align_ins, decode_ins

    for i, (t, q) in enumerate(zip(targets, queries)):
        want_cols, want_ins = banded_align_ins(t, q, 16)
        msg = f"pair {i} len(t)={len(t)} len(q)={len(q)}"
        np.testing.assert_array_equal(got_cols[i], want_cols, err_msg=msg)
        assert got_segs[i] == decode_ins(want_ins), msg


def test_banded_cols_band_cap_fallback():
    rng = np.random.default_rng(3)
    t = encode(_rand_seq(rng, 10))
    q = encode(_rand_seq(rng, 900))   # band 891 > cap → host path
    got_cols, _segs = banded_cols_batch([t], [q], band=8, band_cap=64)
    np.testing.assert_array_equal(got_cols[0], banded_align(t, q, 8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_batch_matches_scalar(seed):
    rng = np.random.default_rng(seed)
    clusters = []
    for _ in range(12):
        base = _rand_seq(rng, int(rng.integers(30, 300)))
        k = int(rng.integers(1, 7))
        clusters.append([_mutate(rng, base) for _ in range(k)])
    clusters.append([])                      # empty
    clusters.append(["ACGT"])                # singleton
    clusters.append(["ACGTACGT"] * 4)        # all identical to medoid
    got = consensus_sequence_batch(clusters)
    for i, seqs in enumerate(clusters):
        assert got[i] == consensus_sequence(seqs), f"cluster {i}"


def test_nbucket():
    from svtrek_tpu.ops.poa_batch import _nbucket, _pow2

    for n in (1, 5, 16, 17, 100, 512):
        assert _nbucket(n) == _pow2(n, 16)          # pow2 regime
    assert _nbucket(513) == 640
    assert _nbucket(640) == 640
    assert _nbucket(641) == 768
    assert _nbucket(1048) == 1280                   # vs pow2's 2048
    assert _nbucket(1800) == 1792 + 256             # 2048
    assert _nbucket(2049) == 2560
    for n in range(1, 5000, 37):
        b = _nbucket(n)
        assert b >= n and (b <= 512 or b < 2 * n)   # waste < 100%


def test_query_overruns_target_bucket():
    """Pairs whose query length exceeds the padded TARGET bucket by more
    than one hit rows i > M + 1, where the old tbig sizing let
    dynamic_slice clamp the row start and silently shift the target
    window (round-5 regression: m=1011 in a 1024 bucket vs n=1048 gave
    wrong tail pointers on every backend)."""
    import numpy as np

    from svtrek_tpu.ops.poa import banded_align_ins, encode
    from svtrek_tpu.ops.poa_batch import _dp_cols_batch

    rng = np.random.default_rng(11)
    BASES = "ACGT"
    cases = [(100, 140, 128), (1011, 1048, 1024)]
    for m, n, Mp in cases:
        t = "".join(BASES[i] for i in rng.integers(0, 4, m))
        # query = target plus an inserted run (keeps the band real)
        q = t[: m // 2] + "".join(
            BASES[i] for i in rng.integers(0, 4, n - m)) + t[m // 2:]
        assert len(q) == n
        te, qe = encode(t), encode(q)
        band = max(16, n - m + 1)
        Np = max(Mp, ((n + 127) // 128) * 128)
        tpad = np.full((1, Mp), 5, np.int8)
        qpad = np.full((1, Np), 5, np.int8)
        tpad[0, :m] = te
        qpad[0, :n] = qe
        W = 16
        while W < band:
            W *= 2
        cols_b, ins_b = (np.asarray(x) for x in _dp_cols_batch(
            tpad, np.array([m], np.int32), qpad, np.array([n], np.int32),
            np.array([band], np.int32), W=W))
        cols_s, ins_s = banded_align_ins(te, qe, band)
        assert np.array_equal(cols_b[0, :m], cols_s), (m, n)
        assert [len(s) for s in ins_s] == list(ins_b[0, : m + 1]), (m, n)
