"""The model FLOPs of the TGN tower, counted from the inputs alone, never
from how the program plans them (multiply-adds as two FLOPs, the peak of
``work.F32_FLOPS_PER_S``).

A train batch of b events embeds 3b roots (src‖dst‖neg) through an
``n_layer``-hop tree of ``n`` neighbours a node. Layer l combines each of
the 3b·n^(L−l) nodes of level L − l with its n children, every slot
counted, padding too (the program computes them all):

- projections: the query, 2·(d + t)² per node; keys and values,
  2·2·(d + e + t)·(d + t) per child; the output, 2·(d + t)² per node;
- attention: scores and the weighted sum, 2·2·(d + t) per child;
- MergeLayer: 2·((d + t + d)·d + d·d) per node.

The link head scores 2b pairs (``work.head_flops`` at width d). The GRU
(``work.gru_flops``, message 2d + e + t) runs once per distinct node of
the batch's tree that holds a pending message, which is what TGN updates
(the program may run it per gathered row; a program that de-duplicates
counts the same), and once per distinct committed positive (the protocol,
not differentiated). Training multiplies the differentiated work by 3.

The tree's nodes come from a search of the train events written here
(each node's events in stream order, strictly before the cut in float32),
so that the GRU's rows are counted from the stream and the epoch's
negatives."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from benchmark import work


def layer_flops(nodes: int, n: int, d: int, t: int, e: int) -> float:
    """One attention layer over ``nodes`` nodes of ``n`` children each."""
    q, k = d + t, d + e + t
    per_node = 2 * q * q + 2 * q * q + 2 * ((q + d) * d + d * d)
    per_child = 2 * 2 * k * q + 2 * 2 * q
    return float(nodes * per_node + nodes * n * per_child)


def tower_flops(roots: int, n: int, n_layer: int, d: int, t: int,
                e: int) -> float:
    """Every layer of the tree over ``roots`` roots."""
    return sum(layer_flops(roots * n ** lvl, n, d, t, e)
               for lvl in range(n_layer))


def train_batch_flops(b: int, n: int, n_layer: int, d: int, t: int, e: int,
                      gru_rows: float, commit_rows: float) -> float:
    msg = 2 * d + e + t
    differentiated = (tower_flops(3 * b, n, n_layer, d, t, e)
                      + work.head_flops(2 * b, d)
                      + work.gru_flops(gru_rows, msg, d))
    return 3 * differentiated + work.gru_flops(commit_rows, msg, d)


class Events:
    """Each node's interactions in stream order, sorted by node, with a
    float64 key node·C + time (C a power of two above every time), so one
    ``searchsorted`` counts a node's events before a cut."""

    def __init__(self, src, dst, t, n_nodes: int):
        src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
        t32 = np.asarray(t, np.float32)
        owner = np.stack([src, dst], 1).reshape(-1)
        other = np.stack([dst, src], 1).reshape(-1)
        ts = np.repeat(t32, 2)
        order = np.argsort(owner, kind="stable")
        self.nbr, self.ts = other[order], ts[order]
        self.start = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(owner, minlength=n_nodes), out=self.start[1:])
        self.c = 2.0 ** np.ceil(np.log2(float(ts.max(initial=0.0)) + 2.0))
        self.key = owner[order] * self.c + self.ts.astype(np.float64)

    def recent(self, nodes: np.ndarray, cuts: np.ndarray, n: int):
        """(nbr, ts) [Q, n] of the ``n`` most recent events of each node
        strictly before its cut, newest first; padding holds node 0 at
        time 0."""
        nodes = np.asarray(nodes, np.int64)
        q = nodes * self.c + np.asarray(cuts, np.float32).astype(np.float64)
        end = np.searchsorted(self.key, q, side="left")
        pos = end[:, None] - 1 - np.arange(n)
        valid = pos >= self.start[nodes][:, None]
        pos = np.where(valid, pos, 0)
        return (np.where(valid, self.nbr[pos], 0),
                np.where(valid, self.ts[pos], np.float32(0)))


def tree_nodes(ev: Events, roots, times, n: int, n_layer: int
               ) -> List[np.ndarray]:
    """The nodes of every level of the hop tree of ``roots`` at
    ``times``."""
    levels = [np.asarray(roots, np.int64)]
    cuts = np.asarray(times, np.float32)
    for _ in range(n_layer):
        nbr, ts = ev.recent(levels[-1], cuts, n)
        levels.append(nbr.reshape(-1))
        cuts = ts.reshape(-1)
    return levels


def gru_rows_per_batch(ev: Events, src, dst, neg, t, bs: int, n: int,
                       n_layer: int, first_batch: np.ndarray,
                       batches: Sequence[int]) -> List[int]:
    """Per train batch ``i`` of ``batches`` (positions in ``src`` … of
    batches of ``bs``): the distinct nodes of its tree that hold a pending
    message (``work.first_batches``: every node that sent a message in an
    earlier batch of the epoch)."""
    out = []
    for i in batches:
        sl = slice(i * bs, (i + 1) * bs)
        roots = np.concatenate([src[sl], dst[sl], neg[sl]])
        times = np.tile(np.asarray(t[sl], np.float32), 3)
        nodes = np.unique(np.concatenate(tree_nodes(ev, roots, times, n,
                                                    n_layer)))
        out.append(int((first_batch[nodes] < i).sum()))
    return out
