"""The arithmetic behind the rooflines and the MFU: what the algorithm needs,
counted from the inputs alone, never from how the program plans it.

Peaks are one NVIDIA H100 SXM's published dense rates at 700 W: 3.35 TB/s
of HBM and 67 TFLOP/s of float32 outside the tensor cores (the
configurations compute in float32 with TF32 off).

The index kernels (``santa_waves``: a training superchunk; ``santa_scan``:
one observe call). Bytes: each distinct row the chunk reads before writing
it read once (the events' src and dst rows, and with extraction their
negatives' rows), each distinct row written once, the extraction rows
written once ([E, 2 + S, F] for S negatives per event), and the columns (4
bytes each of src, dst, edge id, time and every negative, 1 of the valid
flag). Operations: per event, direction and member a top-k of C = L + 1
candidates, L the live entries of the two rows: C·⌈log2 C⌉ compares, 2L for
the twin lookup and the scaling, and 8 for the scales. F = M·(4k + 1)
floats of 4 bytes per row.

The model (per train batch or serve step, multiply-adds as two FLOPs): the
diffusion tower's source MLP on every query row and neighbour MLP on every
(member, query row, slot); the link head on every candidate pair; the GRU
once per distinct selected neighbour with a pending message (the lazy
update) and once per distinct committed node (the protocol). Training adds
the backward at twice the differentiated products (towers, head, lazy GRU);
the commit is not differentiated."""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """Least seconds for this work and what bounds it ('bytes' or
    'operations')."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def row_floats(m: int, k: int) -> int:
    return m * (4 * k + 1)


def merge_ops(live: np.ndarray) -> float:
    """Compares of the merges whose two rows hold ``live`` entries (one
    value per event, direction and member)."""
    c = np.asarray(live, np.float64) + 1
    return float((c * np.ceil(np.log2(np.maximum(c, 2))) + 2 * (c - 1)
                  + 8).sum())


def index_work(src, dst, negs: Optional[np.ndarray], valid, m: int, k: int,
               live: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """(bytes, operations) of one scan of these events. ``negs`` [S, E] or
    None (no extraction); ``live`` [E, 2, M]: the live entries of each
    valid event's src and dst rows before it (None: every row full, 2k, the
    most the compares can be)."""
    src, dst = np.asarray(src), np.asarray(dst)
    valid = np.asarray(valid, bool)
    f = row_floats(m, k) * 4
    vs, vd = src[valid], dst[valid]
    written = len(np.union1d(vs, vd))
    n = len(src)
    if negs is None:
        read, extract, cols = written, 0, n * 17
    else:
        negs = np.atleast_2d(negs)
        read = len(np.union1d(np.union1d(vs, vd), negs[:, valid]))
        extract = int(valid.sum()) * (2 + negs.shape[0]) * f
        cols = n * (17 + 4 * negs.shape[0])
    nbytes = (read + written) * f + extract + cols
    if live is None:
        lanes = np.full((int(valid.sum()) * 2 * m,), 2 * k)
    else:
        # a direction merges its own row with its partner's: L = both rows
        lanes = np.repeat(np.asarray(live).sum(1), 2, axis=0)
    return float(nbytes), merge_ops(lanes)


def tower_flops(rows: int, d: int, t: int, e: int, m: int, k: int) -> float:
    """Diffusion tower over ``rows`` query rows."""
    src = 2 * rows * (d * d + d * d)
    nbr = 2 * m * rows * k * ((d + t + e) * d + d * d)
    return float(src + nbr)


def head_flops(pairs: int, h: int) -> float:
    return float(2 * pairs * (2 * h * h + h))


def gru_flops(rows: float, msg: int, d: int) -> float:
    return float(2 * rows * (msg * 3 * d + d * 3 * d))


def train_batch_flops(b: int, d: int, t: int, e: int, m: int, k: int,
                      lazy_rows: float, commit_rows: float) -> float:
    """One train batch of b events (3b query rows, 2b scored pairs)."""
    h, msg = d * (m + 1), 2 * d + e + t
    differentiated = (tower_flops(3 * b, d, t, e, m, k) + head_flops(2 * b, h)
                      + gru_flops(lazy_rows, msg, d))
    return 3 * differentiated + gru_flops(commit_rows, msg, d)


def serve_step_flops(candidates: int, d: int, t: int, e: int, m: int, k: int,
                     commit_rows: float) -> float:
    """One score of ``candidates`` pairs (2 query rows each) and one
    observe whose protocol commits ``commit_rows`` nodes."""
    h, msg = d * (m + 1), 2 * d + e + t
    return (tower_flops(2 * candidates, d, t, e, m, k)
            + head_flops(candidates, h) + gru_flops(commit_rows, msg, d))


def lazy_rows_per_batch(nbr: Iterable[np.ndarray], w: Iterable[np.ndarray],
                        first_batch: np.ndarray, batches: Iterable[int]
                        ) -> list:
    """Per train batch, the distinct selected neighbours (live entries of
    its queries) that hold a pending message: in training every node that
    sent a message in an earlier batch of the epoch (``first_batch``: each
    node's first batch, a large number for none)."""
    out = []
    for q_nbr, q_w, i in zip(nbr, w, batches):
        sel = np.unique(np.asarray(q_nbr)[np.asarray(q_w) > 0])
        out.append(int((first_batch[sel] < i).sum()))
    return out


def first_batches(src, dst, bs: int, n_nodes: int) -> np.ndarray:
    """Each node's first batch as a sender in a stream of batches of
    ``bs`` events."""
    first = np.full(n_nodes, np.iinfo(np.int64).max, np.int64)
    batch = np.arange(len(src)) // bs
    for ids in (np.asarray(dst), np.asarray(src)):
        np.minimum.at(first, ids, batch)
    return first


def commit_rows(src, dst, first_batch: Optional[np.ndarray], i: int) -> int:
    """Distinct positives of batch ``i`` that hold a pending message
    (``first_batch`` None: every distinct positive, the eval protocol)."""
    pos = np.unique(np.concatenate([src, dst]))
    if first_batch is None:
        return len(pos)
    return int((first_batch[pos] < i).sum())
