"""Banded POA DP: the XLA scan against the scalar anchor, bitwise.

``_dp_cols_batch`` (ops/poa_batch.py, the DP on every backend) must
reproduce the scalar ``banded_align_ins`` exactly — same scores, same
tie-breaking, same walk — across randomized pair batches, length spreads
and band widths.  chip_smoke.py runs the same bodies on the GPU.  The
host side around it (band and length buckets, segment decoding) is
tested here too.
"""
import numpy as np
import pytest

from svtrek_tpu.ops import poa_batch
from svtrek_tpu.ops.poa import banded_align_ins, decode_ins, encode
from svtrek_tpu.ops.poa_batch import (
    UNROLL, _dp_cols_batch, _nbucket, _pow2, _segments_from_counts,
)

BASES = "ACGT"


def _mutate(rng, seq, sub, ins, dele):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        out.append(BASES[rng.integers(4)] if r < dele + sub else c)
        if rng.random() < ins:
            out.append(BASES[rng.integers(4)])
    return "".join(out)


def make_pairs(rng, B, M, band, sub=0.08, ins=0.04, dele=0.04, jitter=40,
               bucket=_pow2):
    """A padded pair batch as banded_cols_batch builds it: targets of
    length M + [0, jitter), queries mutated from them."""
    targets, queries = [], []
    for _ in range(B):
        t = "".join(BASES[i]
                    for i in rng.integers(0, 4,
                                          M + int(rng.integers(0, jitter))))
        targets.append(encode(t))
        queries.append(encode(_mutate(rng, t, sub, ins, dele)))
    Mp = bucket(max(map(len, targets)), 16)
    Np = bucket(max(map(len, queries)), 16)
    bands = np.array([max(band, abs(len(q) - len(t)) + 1)
                      for t, q in zip(targets, queries)], np.int32)
    W = _pow2(int(bands.max()), 16)
    tpad = np.full((B, Mp), 5, np.int8)
    qpad = np.full((B, Np), 5, np.int8)
    ms = np.array([len(t) for t in targets], np.int32)
    ns = np.array([len(q) for q in queries], np.int32)
    for i in range(B):
        tpad[i, : ms[i]] = targets[i]
        qpad[i, : ns[i]] = queries[i]
    return tpad, ms, qpad, ns, bands, W, targets, queries


def degenerate_pairs():
    """Empty query (all-left walk), empty target (all-up walk), and a
    query far longer than the target."""
    rng = np.random.default_rng(5)
    B = 4
    tpad = np.full((B, 128), 5, np.int8)
    qpad = np.full((B, 128), 5, np.int8)
    ms = np.array([40, 0, 10, 60], np.int32)
    ns = np.array([0, 40, 50, 55], np.int32)
    for i in range(B):
        tpad[i, : ms[i]] = rng.integers(0, 4, ms[i]).astype(np.int8)
        qpad[i, : ns[i]] = rng.integers(0, 4, ns[i]).astype(np.int8)
    bands = np.maximum(8, np.abs(ns - ms) + 1).astype(np.int32)
    targets = [tpad[i, : ms[i]] for i in range(B)]
    queries = [qpad[i, : ns[i]] for i in range(B)]
    return tpad, ms, qpad, ns, bands, 64, targets, queries


def assert_matches_scalar(cols, ins, ms, bands, targets, queries):
    """Device (cols, ins-counts) rows equal the scalar anchor's
    (cols, ins-segments) pair by pair."""
    cols, ins = np.asarray(cols), np.asarray(ins)
    for i in range(len(targets)):
        cols_s, ins_s = banded_align_ins(targets[i], queries[i],
                                         int(bands[i]))
        assert np.array_equal(cols[i, : ms[i]], cols_s), i
        assert [len(seg) for seg in ins_s] == list(ins[i, : ms[i] + 1]), i


PARITY_CASES = [
    (1, 8, 200, 16),
    (2, 5, 60, 8),       # short targets, narrow band
    (3, 16, 300, 32),    # band bucket 32
    (4, 4, 500, 64),     # W = 64 storage
    (10, 2, 900, 64),    # long rows
]


@pytest.mark.parametrize("unroll", [1, UNROLL])
@pytest.mark.parametrize("seed,B,M,band", PARITY_CASES)
def test_xla_matches_scalar(seed, B, M, band, unroll):
    rng = np.random.default_rng(seed)
    tpad, ms, qpad, ns, bands, W, targets, queries = make_pairs(
        rng, B, M, band)
    cols, ins = _dp_cols_batch(tpad, ms, qpad, ns, bands, W=W,
                               unroll=unroll)
    assert_matches_scalar(cols, ins, ms, bands, targets, queries)


@pytest.mark.parametrize("unroll", [1, UNROLL])
def test_xla_degenerate_pairs(unroll):
    """The traceback activation / boundary rules on degenerate pairs."""
    tpad, ms, qpad, ns, bands, W, targets, queries = degenerate_pairs()
    cols, ins = _dp_cols_batch(tpad, ms, qpad, ns, bands, W=W,
                               unroll=unroll)
    assert_matches_scalar(cols, ins, ms, bands, targets, queries)


def test_xla_arbitrary_batch_size():
    """B=300 pairs of short targets: any batch size, no tiling."""
    rng = np.random.default_rng(7)
    tpad, ms, qpad, ns, bands, W, targets, queries = make_pairs(
        rng, 300, 30, 8, jitter=4)
    cols, ins = _dp_cols_batch(tpad, ms, qpad, ns, bands, W=W)
    assert np.asarray(cols).shape == (300, tpad.shape[1])
    assert_matches_scalar(cols, ins, ms, bands, targets, queries)


def test_dispatch_matches_scalar_anchor():
    """The production entry (banded_cols_batch, which pads the pairs and
    runs the XLA scan) straight to the scalar anchor, including the
    N-much-longer-than-M regime where the padded target slice must not
    clamp."""
    rng = np.random.default_rng(9)
    _, _, _, _, _, _, targets, queries = make_pairs(
        rng, 6, 120, 16, sub=0.15, ins=0.20, dele=0.02, jitter=10)
    cols, segs = poa_batch.banded_cols_batch(targets, queries, band=16)
    for i in range(len(targets)):
        cols_s, ins_s = banded_align_ins(
            targets[i], queries[i],
            max(16, abs(len(queries[i]) - len(targets[i])) + 1))
        assert np.array_equal(cols[i], cols_s), i
        assert segs[i] == decode_ins(ins_s), i


def _fake_dp(seen):
    def fake(tpad, ms, qpad, ns, bands, *, W):
        seen.append((W, tpad.shape[1], qpad.shape[1], int(bands.max())))
        B, M = tpad.shape
        return np.full((B, M), -1, np.int8), np.zeros((B, M + 1), np.int32)

    return fake


@pytest.mark.parametrize("diff", [0, 20, 60, 130, 300, 511])
def test_batch_band_buckets(monkeypatch, diff):
    """banded_cols_batch stores each batch in the smallest pow2 band
    W >= 16 that holds its widest pair (|n-m|+1 up to band_cap), and pads
    lengths to _nbucket."""
    seen = []
    monkeypatch.setattr(poa_batch, "_dp_cols_batch", _fake_dp(seen))
    rng = np.random.default_rng(diff)
    t = rng.integers(0, 4, 600).astype(np.int8)
    q = rng.integers(0, 4, 600 + diff).astype(np.int8)
    poa_batch.banded_cols_batch([t], [q], band=16, band_cap=512)
    [(W, M, N, band)] = seen
    assert band == max(16, diff + 1)
    assert W == _pow2(band, 16) and W // 2 < band
    assert (M, N) == (_nbucket(600), _nbucket(600 + diff))


class _FakeDevice:
    def __init__(self, platform, device_kind):
        self.platform = platform
        self.device_kind = device_kind


@pytest.mark.parametrize("platform,kind", [("cpu", "cpu"),
                                           ("gpu", "NVIDIA A100-SXM4-80GB")])
def test_xla_scan_on_every_platform(monkeypatch, platform, kind):
    """No platform or card picks another DP: every batch shape goes to
    the XLA scan."""
    seen = []
    monkeypatch.setattr(poa_batch.jax, "devices",
                        lambda *a: [_FakeDevice(platform, kind)])
    monkeypatch.setattr(poa_batch, "_dp_cols_batch", _fake_dp(seen))
    rng = np.random.default_rng(1)
    for B, M in ((1, 100), (256, 1024)):
        _, _, _, _, _, _, targets, queries = make_pairs(
            rng, B, M, 64, jitter=2)
        poa_batch.banded_cols_batch(targets, queries, band=64)
    assert len(seen) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segments_from_counts_matches_scalar(seed):
    """The host decodes each boundary's inserted segment from the
    device's per-boundary counts; it equals the scalar anchor's
    segments."""
    rng = np.random.default_rng(seed)
    _, _, _, _, _, _, targets, queries = make_pairs(
        rng, 8, 80, 16, sub=0.1, ins=0.15, dele=0.05, jitter=20)
    for t, q in zip(targets, queries):
        cols_s, ins_s = banded_align_ins(t, q, max(16, abs(len(q) - len(t)) + 1))
        counts = np.array([len(seg) for seg in ins_s], np.int32)
        assert _segments_from_counts(q, cols_s, counts) == decode_ins(ins_s)
