"""The plain pruning T-PPR query: a bounded temporal BFS, in NumPy.

Per query (node v, time t) and ensemble member (α, β): walk ``depth``
levels of the ``width`` most recent interactions strictly before each
frontier node's time, newest first. A frontier node u with weight w, which
has n interactions before its time, hands its z-th newest neighbour

    w · (1-α) · β / norm · β^z,   norm = β/(1-β) · (1 - β^n)

(times α more at the first level, where α ≠ 0); the child's time is the
interaction's. Weights reaching one (edge id, neighbour) pair add up, and
the answer is the top k pairs by weight, ties by edge id then neighbour,
ascending, with the pair's interaction time. The graph is undirected: each
event is an interaction of both endpoints. Weights are float32."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

F32 = np.float32


class Adjacency:
    """Each node's interactions sorted by time (stream order on ties):
    neighbour, edge id and float32 time."""

    def __init__(self, src, dst, t, eidx, n_nodes: int):
        owner = np.concatenate([src, dst]).astype(np.int64)
        nbr = np.concatenate([dst, src]).astype(np.int64)
        ts = np.concatenate([t, t]).astype(np.float64)
        e = np.concatenate([eidx, eidx]).astype(np.int64)
        order = np.lexsort((ts, owner))
        self.nbr, self.eidx = nbr[order], e[order]
        self.ts = ts[order].astype(F32)
        self.start = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(owner, minlength=n_nodes), out=self.start[1:])

    def before(self, u: int, cut: F32) -> int:
        """How many interactions of ``u`` lie strictly before ``cut``."""
        lo, hi = self.start[u], self.start[u + 1]
        return int(np.searchsorted(self.ts[lo:hi], cut, side="left"))


def pruned_topk(adj: Adjacency, alpha: Sequence[float],
                beta: Sequence[float], nodes, times, width: int, depth: int,
                k: int) -> Dict[str, np.ndarray]:
    """Top-k of each query: fields [M, Q, k] (``w``, ``nbr``, ``eidx``,
    ``dt`` = query time − interaction time); empty slots hold zeros and
    dt equal to the query time."""
    m, q = len(alpha), len(nodes)
    out = dict(w=np.zeros((m, q, k), F32), nbr=np.zeros((m, q, k), np.int64),
               eidx=np.zeros((m, q, k), np.int64),
               dt=np.zeros((m, q, k), F32))
    times = np.asarray(times, F32)
    for j in range(m):
        a, b = F32(alpha[j]), F32(beta[j])
        for i, (v, t) in enumerate(zip(np.asarray(nodes).tolist(), times)):
            cands: Dict[tuple, list] = {}
            frontier = [(v, t, F32(1))]
            for level in range(depth):
                nxt = []
                for u, cut, wu in frontier:
                    n = adj.before(u, cut)
                    norm = b / (F32(1) - b) * (F32(1) - b ** F32(n))
                    base = wu * (F32(1) - a) * b / (norm if norm > 0 else F32(1))
                    if level == 0 and a != 0:
                        base = base * a
                    lo = adj.start[u] + n
                    for z in range(min(width, n)):
                        p = lo - 1 - z
                        wz = base * b ** F32(z)
                        key = (int(adj.eidx[p]), int(adj.nbr[p]))
                        if key in cands:
                            cands[key][0] += wz
                        else:
                            cands[key] = [wz, adj.ts[p]]
                        nxt.append((int(adj.nbr[p]), adj.ts[p], wz))
                frontier = nxt
            ranked = sorted(((-w, e, nb, ts) for (e, nb), (w, ts)
                             in cands.items() if w > 0))[:k]
            out["dt"][j, i] = t
            for slot, (negw, e, nb, ts) in enumerate(ranked):
                out["w"][j, i, slot] = -negw
                out["nbr"][j, i, slot] = nb
                out["eidx"][j, i, slot] = e
                out["dt"][j, i, slot] = t - ts
    return out


def gap(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray]) -> float:
    """L1 distance of the weights keyed by (edge id, neighbour), summed over
    queries and members, over the reference's total weight (an entry held
    by one side only counts whole)."""
    wr, nr, er = ref["w"], ref["nbr"], ref["eidx"]
    wg, ng, eg = got["w"], got["nbr"], got["eidx"]
    same = ((er[..., :, None] == eg[..., None, :])
            & (nr[..., :, None] == ng[..., None, :])
            & (wr[..., :, None] > 0) & (wg[..., None, :] > 0))
    w_match = np.where(same, wg[..., None, :].astype(np.float64), 0).sum(-1)
    dist = np.abs(wr - w_match).sum() + np.where(
        same.any(-2), 0, np.abs(wg.astype(np.float64))).sum()
    return float(dist / max(np.abs(wr.astype(np.float64)).sum(), 1e-30))
