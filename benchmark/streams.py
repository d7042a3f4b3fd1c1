"""The benchmark's inputs, made from the seed: event streams of a
configuration's published shape, their chronological split, the train
negatives of an epoch, and the seeds derived from ``--seed``.

The stream generator is a copy of the port's synthetic generator
(``zebra_tpu_torch/data/synthetic.py``): a bipartite stream with rank
power-law popularity, eight latent communities (80% in-community picks) and
exponential gaps, 1-based node ids with users first. Edge features are not
drawn here: the harness makes them on the device from the seed
(``weights.edge_features``). The split and the train-negative rule follow
the reference's protocol (70/15/15 at the time quantiles, a 10% new-node
holdout drawn with ``random.Random(2020)``; uniform negatives over the
train split's destinations from a ``RandomState`` seeded per epoch)."""

from __future__ import annotations

import random
from typing import Dict, NamedTuple

import numpy as np


def sub_seeds(seed: int, n: int = 4) -> np.ndarray:
    """``n`` seeds below 2^31 derived from ``--seed`` (any whole number):
    the stream's, the weights', the program's and the serve traffic's."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return (ss.generate_state(n, np.uint64) % np.uint64(2 ** 31 - 1)).astype(
        np.int64)


class Events(NamedTuple):
    """Parallel event columns: i64 ids, f64 times, edge ids 1-based."""

    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray
    eidx: np.ndarray

    def take(self, mask) -> "Events":
        return Events(*(c[mask] for c in self))

    def __len__(self) -> int:
        return len(self.src)


def synthetic_events(n_events: int, n_users: int, n_items: int, seed: int,
                     skew: float = 0.9) -> Events:
    """The generator's events (its draws and their order), without the
    edge-feature draw that follows them."""
    rng = np.random.RandomState(seed)
    n_comm = 8

    def popularity(n_pop):
        p = (np.arange(n_pop, dtype=np.float64) + 10.0) ** -skew
        return p / p.sum()

    user_pop, item_pop = popularity(n_users), popularity(n_items)
    user_comm = rng.randint(0, n_comm, n_users)
    item_comm = rng.randint(0, n_comm, n_items)
    users0 = rng.choice(n_users, size=n_events, p=user_pop)
    items0 = np.zeros(n_events, np.int64)
    in_comm = rng.rand(n_events) < 0.8
    all_items = rng.choice(n_items, size=n_events, p=item_pop)
    items0[~in_comm] = all_items[~in_comm]
    for c in range(n_comm):
        members = np.where(item_comm == c)[0]
        sel = in_comm & (user_comm[users0] == c)
        if len(members) == 0:
            items0[sel] = all_items[sel]
            continue
        pc = item_pop[members] / item_pop[members].sum()
        items0[sel] = members[rng.choice(len(members), size=int(sel.sum()),
                                         p=pc)]
    t = np.cumsum(rng.exponential(1.0, n_events))
    return Events(1 + users0.astype(np.int64),
                  1 + n_users + items0.astype(np.int64), t,
                  np.arange(1, n_events + 1, dtype=np.int64))


class Split(NamedTuple):
    full: Events
    train: Events
    val: Events
    test: Events
    new_node_val: Events
    new_node_test: Events
    n_nodes: int


def split(ev: Events, new_node_seed: int = 2020) -> Split:
    """The chronological 70/15/15 split with the inductive holdout: 10% of
    all nodes, drawn from the nodes active after the validation cut, lose
    their train edges; new-node sets are the val/test edges touching a node
    unseen in training."""
    val_time, test_time = np.quantile(ev.t, (0.70, 0.85))
    nodes = np.union1d(ev.src, ev.dst)
    late = ev.t > val_time
    late_nodes = np.union1d(ev.src[late], ev.dst[late])
    held = np.array(sorted(random.Random(new_node_seed).sample(
        late_nodes.tolist(), int(0.1 * len(nodes)))), np.int64)
    observed = ~np.isin(ev.src, held) & ~np.isin(ev.dst, held)
    train = ev.take((ev.t <= val_time) & observed)
    new_nodes = np.setdiff1d(nodes, np.union1d(train.src, train.dst))
    val_mask = (ev.t <= test_time) & (ev.t > val_time)
    test_mask = ev.t > test_time
    touches = np.isin(ev.src, new_nodes) | np.isin(ev.dst, new_nodes)
    n_nodes = max(int(max(ev.src.max(), ev.dst.max())), len(nodes))
    return Split(ev, train, ev.take(val_mask), ev.take(test_mask),
                 ev.take(val_mask & touches), ev.take(test_mask & touches),
                 n_nodes)


def neg_base(program_seed: int) -> int:
    """The base of a seed's per-epoch train negatives: the first draw of a
    ``RandomState`` seeded with the seed."""
    return int(np.random.RandomState(program_seed).randint(0, 2 ** 31 - 1))


def train_negatives(train: Events, base: int, epoch: int) -> np.ndarray:
    """Epoch ``epoch``'s train negatives: uniform over the train split's
    distinct destinations, drawn (sources first, then destinations) from a
    ``RandomState`` seeded with (base + 0x9E3779B1·(epoch + 1)) mod 2^32."""
    rs = np.random.RandomState((int(base) + 0x9E3779B1 * (epoch + 1))
                               % (2 ** 32))
    n = len(train)
    srcs, dsts = np.unique(train.src), np.unique(train.dst)
    rs.randint(0, len(srcs), n)
    return dsts[rs.randint(0, len(dsts), n)]


def chunk_geometry(n_events: int, bs: int, index_chunk: int) -> Dict[str, int]:
    """How a stream of ``n_events`` cuts into superchunks of whole batches
    (the trainer's padding rule): batches, superchunks, batches per
    superchunk, and each superchunk's real events."""
    real_batches = max(1, -(-n_events // bs))
    n_chunks = min(real_batches,
                   max(1, -(-(real_batches * bs) // index_chunk)))
    per_chunk = -(-real_batches // n_chunks)
    events = [max(0, min(n_events, (c + 1) * per_chunk * bs)
                  - c * per_chunk * bs) for c in range(n_chunks)]
    return dict(real_batches=real_batches, n_chunks=n_chunks,
                per_chunk=per_chunk, chunk_events=events)
