"""Ad-hoc stage profiler for the audit step (GPU or CPU)."""
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

import svtrek_tpu  # noqa: F401
from svtrek_tpu.ops.cigar import extract_read_candidates, group_candidates_by_window
from svtrek_tpu.ops.consensus import consensus_pos_batch
from bench import make_workload, B, K


def timeit(name, fn, n=5):
    r = fn()
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    jax.block_until_ready(r)
    print(f"{name}: {(time.perf_counter() - t0) / n * 1000:.1f} ms", flush=True)
    return r


def main():
    print("building workload...", flush=True)
    work = make_workload()
    ops, lens, pos, n_ops, wid, kind, istart, iend, ipos = work
    ops, lens = jax.device_put(ops), jax.device_put(lens)
    pos32 = jax.device_put(pos.astype(np.int32))
    n_ops, wid = jax.device_put(n_ops), jax.device_put(wid)
    kindd = jax.device_put(kind)
    istart32, iend32, ipos32 = [
        jax.device_put(x.astype(np.int32)) for x in (istart, iend, ipos)
    ]
    print("workload on device", flush=True)

    kind_r = jnp.take(kindd, jnp.clip(wid, 0, B - 1))
    is_r = jnp.take(istart32, jnp.clip(wid, 0, B - 1))
    ie_r = jnp.take(iend32, jnp.clip(wid, 0, B - 1))

    cand = timeit(
        "extract",
        lambda: extract_read_candidates(ops, lens, pos32, n_ops, kind_r, is_r, ie_r),
    )[0]
    locs, counts, _ = timeit(
        "group", lambda: group_candidates_by_window(cand, wid, B, K)
    )
    counts_c = jnp.minimum(counts, K)
    timeit("consensus", lambda: consensus_pos_batch(locs, counts_c, ipos32))


if __name__ == "__main__":
    main()
