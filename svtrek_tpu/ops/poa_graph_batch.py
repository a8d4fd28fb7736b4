"""Batched TRUE partial-order alignment DP on device.

The "banded DP over the POA graph as the inner loop" of the north star
(BASELINE.json; the reference's abPOA slot, SURVEY.md §2.14), batched
batched: every active cluster aligns its next member to its graph in
ONE jitted XLA program per round.

Formulation (dense, not anti-diagonal):

* the graph arrives as padded topo-order arrays (PoaGraph.to_arrays):
  per DP row a base, up to P predecessor ROW indices (0 = virtual
  start) in the scalar align()'s preference order, and a sink flag;
* one ``lax.scan`` step per GRAPH NODE: gather the P predecessor rows
  of H ([P, N+1]), build the candidate stack in preference order
  [del_p0, diag_p0, del_p1, diag_p1, ...] and take a first-wins argmax
  (exactly the scalar's strict-``>`` update order), then resolve in-row
  query insertions with the max-plus ``cummax`` prefix scan (the same
  trick as ops/poa_batch.py);
* traceback also runs on device: a second scan over the int8
  move/pred-choice tensors emits per-node matched flags and per-row
  insertion counts — the compact form the host threads back into the
  graph (matches + insertions are all add_alignment needs; deletions
  change nothing);
* ``vmap`` over the cluster batch; (P, Vmax, Nmax) are bucketed
  pow2 static shapes.

Property-tested bit-identical to the scalar oracle (PoaGraph.align) in
tests/test_poa_graph.py; quality measured head-to-head vs the star MSA
in the same file.  Scores int32; NEG = -2^28.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .poa import GAP, MATCH, MISMATCH, encode
from .poa_graph import NEG, PoaGraph


def _graph_dp_one(base_td, pred_rows, npred, is_sink, V, q, n,
                  *, P: int, Vmax: int, Nmax: int):
    """DP + traceback for one (graph, query) pair.  Returns
    (score, matched [Vmax] int8, ins_after [Vmax+1] int32)."""
    cols = jnp.arange(Nmax + 1, dtype=jnp.int32)
    jvalid = cols <= n
    gapj = GAP * cols

    H0 = jnp.full((Vmax + 1, Nmax + 1), NEG, jnp.int32)
    H0 = H0.at[0].set(jnp.where(jvalid, gapj, NEG))

    parity = jnp.arange(2 * P, dtype=jnp.int32) % 2       # 0=del, 1=diag
    pidx = jnp.arange(2 * P, dtype=jnp.int32) // 2

    def step(H, i):
        row_ok = i <= V
        prs = pred_rows[i - 1]                             # [P] row idx
        rows = H[prs]                                      # [P, N+1]
        pvalid = jnp.arange(P) < npred[i - 1]
        b = base_td[i - 1]
        # sub[j] compares q[j-1]; shift query right by one column.
        subq = jnp.where(q == b, MATCH, MISMATCH).astype(jnp.int32)
        sub = jnp.concatenate([jnp.full((1,), NEG, jnp.int32), subq])
        del_c = rows + GAP                                 # [P, N+1]
        diag_c = (jnp.concatenate(
            [jnp.full((P, 1), NEG, rows.dtype), rows[:, :-1]], axis=1)
            + sub[None, :])
        # preference stack [del_p0, diag_p0, del_p1, diag_p1, ...]
        cand = jnp.where((parity == 0)[:, None], del_c[pidx], diag_c[pidx])
        cand = jnp.where(pvalid[pidx][:, None], cand, NEG)
        best = jnp.max(cand, axis=0)
        sel = jnp.argmax(cand, axis=0).astype(jnp.int32)   # first max wins
        base_move = jnp.where(parity[sel] == 0, jnp.int8(1), jnp.int8(0))
        base_psel = pidx[sel].astype(jnp.int8)
        # in-row insertions: final[j] = max(best[j], max_{j'<j} final[j']
        # + GAP*(j-j')) via exclusive cummax of best[j'] - GAP*j'.
        g = best - gapj
        cm = jax.lax.cummax(g, axis=0)
        exc = jnp.concatenate([jnp.full((1,), NEG, cm.dtype), cm[:-1]])
        left = exc + gapj
        use_ins = left > best                              # strict (scalar)
        row = jnp.where(use_ins, left, best)
        move = jnp.where(use_ins, jnp.int8(2), base_move)
        psel = jnp.where(use_ins, jnp.int8(0), base_psel)
        row = jnp.where(jvalid, row, NEG)
        row = jnp.where(row_ok, row, NEG)
        H = jax.lax.dynamic_update_slice(H, row[None], (i, 0))
        return H, (move, psel)

    H, (moves, psels) = jax.lax.scan(
        step, H0, jnp.arange(1, Vmax + 1, dtype=jnp.int32))
    # moves/psels: [Vmax, N+1]; row r = DP row r+1.

    finals = H[1:, n]                                      # H[i, n] per row
    sink_ok = is_sink & (jnp.arange(Vmax) < V)
    scores = jnp.where(sink_ok, finals, NEG)
    end_row = jnp.argmax(scores).astype(jnp.int32) + 1     # lowest rank tie
    score = scores[end_row - 1]

    def tb(carry, _):
        i, j, matched, ins_after = carry
        active = (i > 0) | (j > 0)
        m = moves[jnp.maximum(i - 1, 0), j]
        m = jnp.where(i == 0, jnp.int8(2), m)
        dg = active & (m == 0)
        dl = active & (m == 1)
        ins = active & (m == 2)
        matched = matched.at[jnp.maximum(i - 1, 0)].set(
            jnp.where(dg, jnp.int8(1), matched[jnp.maximum(i - 1, 0)]))
        ins_after = ins_after.at[jnp.clip(i, 0, Vmax)].add(
            ins.astype(jnp.int32))
        p = psels[jnp.maximum(i - 1, 0), j].astype(jnp.int32)
        prow = pred_rows[jnp.maximum(i - 1, 0), p]
        i = jnp.where(dg | dl, prow, i)
        j = j - (dg | ins).astype(j.dtype)
        return (i, j, matched, ins_after), None

    matched0 = jnp.zeros(Vmax, jnp.int8)
    ins0 = jnp.zeros(Vmax + 1, jnp.int32)
    (_, _, matched, ins_after), _ = jax.lax.scan(
        tb, (end_row, n, matched0, ins0), None, length=Vmax + Nmax)
    return score, matched, ins_after


@functools.partial(jax.jit, static_argnames=("P", "Vmax", "Nmax"))
def _graph_dp_batch(base_td, pred_rows, npred, is_sink, Vs, qs, ns,
                    *, P, Vmax, Nmax):
    return jax.vmap(
        functools.partial(_graph_dp_one, P=P, Vmax=Vmax, Nmax=Nmax)
    )(base_td, pred_rows, npred, is_sink, Vs, qs, ns)


def _pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def path_from_device(arrs, matched, ins_after, q: np.ndarray):
    """Reconstruct the scalar align() path (minus deletions, which
    add_alignment ignores) from the kernel's compact traceback: leading
    insertions, then per matched topo row its aligned query base and
    the insertions that follow it.  Query is consumed monotonically."""
    order = arrs["order"]
    path: list[tuple[int | None, int]] = []
    c = 0
    for _ in range(int(ins_after[0])):
        path.append((None, c))
        c += 1
    for r in range(int(arrs["V"])):
        if matched[r]:
            path.append((order[r], c))
            c += 1
        for _ in range(int(ins_after[r + 1])):
            path.append((None, c))
            c += 1
    assert c == len(q), (c, len(q))
    return path


def align_batch(graphs: list[PoaGraph], queries: list[np.ndarray]):
    """Align query[i] to graph[i] for the whole batch in one device
    program.  Returns (paths, scores) — paths in add_alignment form.
    Callers guard sizes (see consensus_sequence_poa_batch)."""
    B = len(graphs)
    P = _pow2(max(max(g.max_indegree(), 1) for g in graphs), 2)
    Vmax = _pow2(max(len(g.base) for g in graphs), 16)
    Nmax = _pow2(max(len(q) for q in queries), 16)
    arrs = [g.to_arrays(Vmax, P) for g in graphs]
    base_td = np.stack([a["base_td"] for a in arrs])
    pred_rows = np.stack([a["pred_rows"] for a in arrs])
    npred = np.stack([a["npred"] for a in arrs])
    is_sink = np.stack([a["is_sink"] for a in arrs])
    Vs = np.array([a["V"] for a in arrs], np.int32)
    qpad = np.full((B, Nmax), 5, np.int8)
    ns = np.zeros(B, np.int32)
    for i, q in enumerate(queries):
        qpad[i, : len(q)] = q
        ns[i] = len(q)
    scores, matched, ins_after = (np.asarray(x) for x in _graph_dp_batch(
        base_td, pred_rows, npred, is_sink, Vs, qpad, ns,
        P=P, Vmax=Vmax, Nmax=Nmax))
    paths = [path_from_device(arrs[i], matched[i], ins_after[i],
                              queries[i]) for i in range(B)]
    return paths, scores


# Caps beyond which a cluster falls back to the scalar star path (the
# dense DP's compiled shape would be dominated by one outlier).
V_CAP = 2048
N_CAP = 1024
P_CAP = 32


def consensus_sequence_poa_batch(clusters: list[list[str]]) -> list[str]:
    """True-POA consensus of many clusters, device-batched per round:
    round k aligns every active cluster's k-th member to its graph in
    one program (the graph-threading update is host work).  Semantics
    identical to the scalar consensus_sequence_poa (same seed choice,
    same preference order) — property-tested."""
    from .poa_graph import consensus_sequence_poa

    results: list[str | None] = [None] * len(clusters)
    state: dict[int, tuple[PoaGraph, list[str], int]] = {}
    for ci, seqs in enumerate(clusters):
        seqs = [s for s in seqs if s]
        if not seqs:
            results[ci] = ""
            continue
        if len(seqs) == 1:
            results[ci] = seqs[0]
            continue
        if max(len(s) for s in seqs) > N_CAP:
            results[ci] = consensus_sequence_poa(seqs)
            continue
        order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        seed = order[len(order) // 2]
        g = PoaGraph()
        g.add_first(encode(seqs[seed]))
        rest = [s for i, s in enumerate(seqs) if i != seed]
        state[ci] = (g, rest, 0)

    while state:
        batch_ci, batch_g, batch_q = [], [], []
        for ci, (g, rest, k) in list(state.items()):
            if k >= len(rest):
                results[ci] = g.consensus()
                del state[ci]
                continue
            if (len(g.base) > V_CAP or g.max_indegree() > P_CAP):
                # outlier graph: finish scalar
                for s in rest[k:]:
                    q = encode(s)
                    path, _ = g.align(q)
                    g.add_alignment(q, path)
                results[ci] = g.consensus()
                del state[ci]
                continue
            batch_ci.append(ci)
            batch_g.append(g)
            batch_q.append(encode(rest[k]))
        if not batch_ci:
            continue
        paths, _ = align_batch(batch_g, batch_q)
        for ci, q, path in zip(batch_ci, batch_q, paths):
            g, rest, k = state[ci]
            g.add_alignment(q, path)
            state[ci] = (g, rest, k + 1)
    return results  # type: ignore[return-value]
