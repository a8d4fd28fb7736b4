"""Ad-hoc profiler for the batched banded-DP kernel: POA DP cells/sec
(the net-new kernel metric from BASELINE.md; no reference analog —
abPOA is declared but unused in the reference, SURVEY.md §2.14).

Workload: B (target, query) pairs, query = mutated target, typical INS
consensus shapes.  Reports effective DP cells/sec (sum n_i x band
width_i, what the scalar anchor would compute) and the device-computed
padded cells/sec, vs the scalar numpy anchor on one pair extrapolated.
"""
import sys
import time

import numpy as np

from svtrek_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax  # noqa: E402

from svtrek_tpu.ops.poa import banded_align, encode  # noqa: E402
from svtrek_tpu.ops.poa_batch import _dp_cols_batch, _pow2  # noqa: E402

B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
M = int(sys.argv[2]) if len(sys.argv) > 2 else 1024   # target len
BAND = int(sys.argv[3]) if len(sys.argv) > 3 else 64
ITERS = 20
BASES = "ACGT"


def mutate(rng, seq, sub=0.05, ins=0.02, dele=0.02):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        out.append(BASES[rng.integers(4)] if r < dele + sub else c)
        if rng.random() < ins:
            out.append(BASES[rng.integers(4)])
    return "".join(out)


def main():
    rng = np.random.default_rng(0)
    targets, queries = [], []
    for _ in range(B):
        t = "".join(BASES[i] for i in rng.integers(0, 4, M))
        targets.append(encode(t))
        queries.append(encode(mutate(rng, t)))
    Mp = _pow2(max(len(t) for t in targets), 16)
    Np = _pow2(max(len(q) for q in queries), 16)
    bands = np.array(
        [max(BAND, abs(len(q) - len(t)) + 1)
         for t, q in zip(targets, queries)], np.int32)
    W = _pow2(int(bands.max()), 16)
    tpad = np.full((B, Mp), 5, np.int8)
    qpad = np.full((B, Np), 5, np.int8)
    ms = np.array([len(t) for t in targets], np.int32)
    ns = np.array([len(q) for q in queries], np.int32)
    for i in range(B):
        tpad[i, : ms[i]] = targets[i]
        qpad[i, : ns[i]] = queries[i]
    args = [jax.device_put(x) for x in (tpad, ms, qpad, ns, bands)]

    print(f"dev={jax.devices()[0].platform} B={B} M={M} band={BAND} "
          f"Mp={Mp} Np={Np} W={W}", flush=True)
    r = _dp_cols_batch(*args, W=W)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        r = _dp_cols_batch(*args, W=W)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / ITERS

    eff_cells = int((ns.astype(np.int64) * (2 * bands + 1)).sum())
    dev_cells = B * Np * (2 * W + 1)
    print(f"batch time: {dt * 1e3:.2f} ms")
    print(f"effective DP cells/sec: {eff_cells / dt:.3e}")
    print(f"device padded cells/sec: {dev_cells / dt:.3e}")

    # scalar numpy anchor, one pair, extrapolated
    t0 = time.perf_counter()
    banded_align(targets[0], queries[0], BAND)
    s_dt = time.perf_counter() - t0
    s_cells = len(queries[0]) * (2 * bands[0] + 1)
    print(f"scalar anchor cells/sec: {s_cells / s_dt:.3e} "
          f"(speedup {eff_cells / dt / (s_cells / s_dt):.1f}x)")


if __name__ == "__main__":
    main()
