"""The plain streaming top-k T-PPR index (SANTA), in NumPy.

State per ensemble member j (α_j, β_j): a norm per node and a list of at
most k entries (weight, neighbour, edge id, entry time). An event
(s1, s2, t, e) updates both endpoints from their pre-event lists:

    new_norm = norm·β + β
    own entries decay by  norm / new_norm · β        (0 for an empty list)
    the partner's entries join, scaled by  β / new_norm · (1 - α)
      (an entry already held, same edge id and neighbour, adds its weight)
    the fresh entry (e, s2, t) enters with  β / new_norm · (1 - α) · α
      (without the ·α where α = 0)
    keep the top k by weight, ties by edge id then neighbour, ascending.

Queries read an endpoint's list before the event's update ("extract before
update"). The state is float32, as the configurations state it; with
``low=True`` weights and norms are rounded to bfloat16 after every update,
the control's precision. Events are applied in levels: an event's level is
past every earlier event that wrote a row it reads and not before any
earlier event that read a row it writes, so the events of a level touch
pairwise distinct rows, read before anything of their level is written, and
the result is that of stream order."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

F32 = np.float32


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 → the nearest bfloat16 value (ties to even), as float32."""
    u = np.ascontiguousarray(x, F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


class Index:
    """Fields [M, N, k]: ``w`` f32, ``nbr`` i64, ``eidx`` i64, ``ts`` f32;
    ``norm`` f32 [M, N]."""

    def __init__(self, n_nodes: int, alpha: Sequence[float],
                 beta: Sequence[float], k: int, low: bool = False):
        m = len(alpha)
        self.alpha = np.asarray(alpha, F32)[:, None]
        self.beta = np.asarray(beta, F32)[:, None]
        self.k, self.low = int(k), low
        self.w = np.zeros((m, n_nodes, k), F32)
        self.nbr = np.zeros((m, n_nodes, k), np.int64)
        self.eidx = np.zeros((m, n_nodes, k), np.int64)
        self.ts = np.zeros((m, n_nodes, k), F32)
        self.norm = np.zeros((m, n_nodes), F32)

    @classmethod
    def from_packed(cls, data: np.ndarray, alpha, beta, k: int,
                    low: bool = False) -> "Index":
        """An index holding packed rows ``data`` [N, M·(4k+1)] (per member
        the k weights, neighbours, edge ids and times, then the M norms)."""
        m = len(alpha)
        idx = cls(data.shape[0], alpha, beta, k, low)
        fields = data[:, : 4 * m * k].reshape(-1, m, 4, k).transpose(2, 1, 0, 3)
        idx.w = np.ascontiguousarray(fields[0], F32)
        idx.nbr = fields[1].astype(np.int64)
        idx.eidx = fields[2].astype(np.int64)
        idx.ts = np.ascontiguousarray(fields[3], F32)
        idx.norm = np.ascontiguousarray(data[:, 4 * m * k:].T, F32)
        return idx

    def rows(self, nodes: np.ndarray) -> Tuple[np.ndarray, ...]:
        """(w, nbr, eidx, ts) of ``nodes`` [...]: each [M, ..., k]."""
        return (self.w[:, nodes], self.nbr[:, nodes], self.eidx[:, nodes],
                self.ts[:, nodes])

    def _merge(self, own, partner, norm1, new_node, e, t):
        """New lists of W endpoints from their own and their partner's
        pre-event lists (fields [M, W, k]), own norms [M, W], the fresh
        entries' neighbour, edge id and time [W]."""
        a, b = self.alpha, self.beta
        w1r, n1, e1, t1 = own
        w2r, n2, e2, t2 = partner
        new_norm = norm1 * b + b
        scale1 = norm1 / new_norm * b
        scale2 = b / new_norm * (F32(1) - a)
        v1, v2 = w1r > 0, w2r > 0
        w2 = w2r * scale2[..., None]
        match = ((e1[..., :, None] == e2[..., None, :])
                 & (n1[..., :, None] == n2[..., None, :])
                 & v1[..., :, None] & v2[..., None, :])
        w1 = w1r * scale1[..., None] + np.where(match, w2[..., None, :],
                                                F32(0)).sum(-1, dtype=F32)
        w2 = np.where(v2 & ~match.any(-2), w2, F32(0))
        fresh = np.where(a != 0, scale2 * a, scale2)[..., None]
        shape = w1.shape[:-1] + (1,)
        cw = np.concatenate([w1, w2, fresh], -1)
        cn = np.concatenate([n1, n2, np.broadcast_to(new_node[None, :, None],
                                                     shape)], -1)
        ce = np.concatenate([e1, e2, np.broadcast_to(e[None, :, None], shape)],
                            -1)
        ct = np.concatenate([t1, t2, np.broadcast_to(t[None, :, None], shape)],
                            -1)
        order = np.lexsort((cn, ce, -cw), axis=-1)[..., : self.k]
        pick = lambda x: np.take_along_axis(x, order, -1)
        w = pick(cw)
        live = w > 0
        if self.low:
            w, new_norm = round_bf16(w), round_bf16(new_norm)
        return ((np.where(live, w, F32(0)), np.where(live, pick(cn), 0),
                 np.where(live, pick(ce), 0),
                 np.where(live, pick(ct), F32(0))), new_norm)

    def _apply(self, src, dst, e, t) -> None:
        """Update node-disjoint events (one level) from their pre-level
        rows."""
        rs, rd = self.rows(src), self.rows(dst)
        ns, nd = self.norm[:, src], self.norm[:, dst]
        new_s = self._merge(rs, rd, ns, dst, e, t)
        new_d = self._merge(rd, rs, nd, src, e, t)
        for nodes, (fields, norm) in ((src, new_s), (dst, new_d)):
            for table, f in zip((self.w, self.nbr, self.eidx, self.ts),
                                fields):
                table[:, nodes] = f
            self.norm[:, nodes] = norm

    def scan(self, src, dst, t, eidx, negs: Optional[np.ndarray] = None,
             extract: bool = False) -> Optional[Dict[str, np.ndarray]]:
        """Apply events in stream order. ``negs`` [R, E] are further rows
        each event reads (one negative per seed). With ``extract``, returns
        each event's pre-event lists of [src, dst, *negs]: fields
        [E, R+2, M, k] (``w``, ``nbr``, ``eidx``, ``ts``)."""
        src, dst, eidx = (np.asarray(c, np.int64) for c in (src, dst, eidx))
        t = np.asarray(t, F32)
        negs = (np.zeros((0, len(src)), np.int64) if negs is None
                else np.atleast_2d(np.asarray(negs, np.int64)))
        reads = np.concatenate([src[None], dst[None], negs]) if extract \
            else np.stack([src, dst])
        level = levels(src, dst, reads)
        order = np.argsort(level, kind="stable")
        cuts = np.flatnonzero(np.diff(level[order])) + 1
        out = None
        if extract:
            r, m, k = reads.shape[0], self.w.shape[0], self.k
            out = dict(w=np.zeros((len(src), r, m, k), F32),
                       nbr=np.zeros((len(src), r, m, k), np.int64),
                       eidx=np.zeros((len(src), r, m, k), np.int64),
                       ts=np.zeros((len(src), r, m, k), F32))
        for lv in np.split(order, cuts):
            if extract:
                got = self.rows(reads[:, lv])        # each [M, R, W, k]
                for name, f in zip(("w", "nbr", "eidx", "ts"), got):
                    out[name][lv] = f.transpose(2, 1, 0, 3)
            self._apply(src[lv], dst[lv], eidx[lv], t[lv])
        return out


def levels(src: np.ndarray, dst: np.ndarray, reads: np.ndarray) -> np.ndarray:
    """Each event's level: after the last level that wrote a row it reads,
    and not before the last level that read a row it writes (src, dst)."""
    last_w: Dict[int, int] = {}
    last_r: Dict[int, int] = {}
    out = np.empty(len(src), np.int64)
    reads_t = reads.T.tolist()
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        rd = reads_t[i]
        lv = max(max(last_w.get(x, -1) + 1 for x in rd),
                 last_r.get(s, 0), last_r.get(d, 0))
        out[i] = lv
        last_w[s] = last_w[d] = lv
        for x in rd:
            if last_r.get(x, 0) < lv:
                last_r[x] = lv
    return out


def gap(ref: Index, got: Index, nodes: Optional[np.ndarray] = None) -> float:
    """How far ``got``'s lists lie from ``ref``'s: the L1 distance of the
    weights keyed by (edge id, neighbour), summed over nodes and members,
    over the reference's total weight. An entry held by one side only
    counts whole; the norms add their own relative distance."""
    sel = slice(None) if nodes is None else nodes
    wr, nr, er = ref.w[:, sel], ref.nbr[:, sel], ref.eidx[:, sel]
    wg, ng, eg = got.w[:, sel], got.nbr[:, sel], got.eidx[:, sel]
    same = ((er[..., :, None] == eg[..., None, :])
            & (nr[..., :, None] == ng[..., None, :])
            & (wr[..., :, None] > 0) & (wg[..., None, :] > 0))
    w_match = np.where(same, wg[..., None, :].astype(np.float64), 0).sum(-1)
    dist = np.abs(wr - w_match).sum() + np.where(
        same.any(-2), 0, np.abs(wg.astype(np.float64))).sum()
    total = np.abs(wr.astype(np.float64)).sum()
    norm_r = np.abs(ref.norm[:, sel].astype(np.float64))
    norm_d = np.abs(ref.norm[:, sel] - got.norm[:, sel].astype(np.float64))
    return float(dist / max(total, 1e-30)
                 + norm_d.sum() / max(norm_r.sum(), 1e-30))
