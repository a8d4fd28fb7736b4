#!/usr/bin/env python
"""CPU-mesh strong-scaling curve for the sharded audit step.

Run by bench.py's bench_scaling stage in a subprocess with
JAX_PLATFORMS=cpu and xla_force_host_platform_device_count=8 (the same
virtual-device mesh the multi-chip dryrun uses): fixed total work, mesh
sizes 1/2/4/8, best-of-3 timing windows.  Prints one JSON line.

Caveat printed with the result: virtual-device scaling saturates at
the host's physical core count no matter how clean the sharding is;
the curve demonstrates the shard_map step's *overhead*
behavior (a flat efficiency collapse would indicate sharding overhead;
a plateau at the core count is the hardware ceiling).  Device scaling
requires real cards (BASELINE.md metric 4's 2-host config).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from svtrek_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

B = 4096           # total windows (fixed work, divisible by 8)
ITERS = 10


def main():
    import jax
    import numpy as np

    import bench
    from svtrek_tpu.parallel.mesh import make_mesh, sharded_audit_step

    # Reuse the kernel benchmark's synthetic refine windows.
    bench.B = B
    work = bench.make_workload()
    ops, lens, pos, n_ops, wid, kind, istart, iend, ipos = work

    devices = jax.devices()
    times = {}
    # SVTREK_SCALING_N: time only these mesh sizes (the core-pinned
    # hardware-scaling runs measure just the full 8-way mesh).
    only = os.environ.get("SVTREK_SCALING_N", "")
    sizes = tuple(int(x) for x in only.split(",")) if only else (1, 2, 4, 8)
    for n in sizes:
        if n > len(devices):
            continue
        mesh = make_mesh(devices[:n])
        step = sharded_audit_step(mesh, num_windows=B, K=64)
        b_loc = B // n
        wid_local = (wid % b_loc).astype(np.int32)
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P("data"))
        args = [jax.device_put(x, sh) for x in (
            ops, lens, pos.astype(np.int32), n_ops, wid_local, kind,
            istart.astype(np.int32), iend.astype(np.int32),
            ipos.astype(np.int32))]
        r = step(*args)
        jax.block_until_ready(r)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                r = step(*args)
            jax.block_until_ready(r)
            best = min(best, time.perf_counter() - t0)
        times[n] = best / ITERS

    t1 = times.get(1)
    curve = {str(n): {"step_ms": round(t * 1e3, 3),
                      **({"speedup": round(t1 / t, 3),
                          "efficiency": round(t1 / (n * t), 3)}
                         if t1 else {})}
             for n, t in times.items()}

    # Per-shard batch-size sweep (VERDICT r3 item 6): fixed 8 shards,
    # B/shard swept — separates per-shard overhead from the XLA-CPU
    # multithreading artifact in the mesh-size curve.  The per-window
    # cost knee marks where sharding overhead is amortized.
    sweep = {}
    if os.environ.get("SVTREK_SCALING_SWEEP") and len(devices) >= 8:
        mesh = make_mesh(devices[:8])
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P("data"))
        for bps in (256, 512, 1024, 2048, 4096, 8192):
            B_tot = 8 * bps
            bench.B = B_tot
            ops, lens, pos, n_ops, wid, kind, istart, iend, ipos = \
                bench.make_workload()
            step = sharded_audit_step(mesh, num_windows=B_tot, K=64)
            wid_local = (wid % bps).astype(np.int32)
            args = [jax.device_put(x, sh) for x in (
                ops, lens, pos.astype(np.int32), n_ops, wid_local, kind,
                istart.astype(np.int32), iend.astype(np.int32),
                ipos.astype(np.int32))]
            r = step(*args)
            jax.block_until_ready(r)
            # Steps at the big sweep points run seconds each; 2x2 there
            # keeps the whole stage inside its bench budget.
            n_win, n_it = (3, 3) if bps < 2048 else (2, 2)
            best = float("inf")
            for _ in range(n_win):
                t0 = time.perf_counter()
                for _ in range(n_it):
                    r = step(*args)
                jax.block_until_ready(r)
                best = min(best, (time.perf_counter() - t0) / n_it)
            sweep[str(bps)] = round(best * 1e3, 3)

    print("SCALING_JSON:" + json.dumps({
        "total_windows": B,
        "curve": curve,
        "shard_batch_sweep": sweep,
        "physical_cores": os.cpu_count(),
    }))


if __name__ == "__main__":
    main()
