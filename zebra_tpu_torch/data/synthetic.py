"""Synthetic temporal interaction streams (numpy copy of
``zebra_tpu/data/synthetic.py``: the same seed gives the identical stream).

A bipartite JODIE-style stream with preferential-attachment-ish node reuse
and increasing timestamps: 1-based node ids, 1-based edge idxs, optional
edge features with a zero padding row."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from zebra_tpu_torch.data.dataset import Data


def synthetic_stream(
    n_events: int,
    n_users: int,
    n_items: int,
    edge_dim: int = 0,
    seed: int = 0,
    skew: float = 0.9,
    label_users_frac: float = 0.0,
) -> Tuple[Data, Optional[np.ndarray]]:
    """Return a chronological Data stream plus an edge-feature matrix of shape
    ``[n_events + 1, edge_dim]`` (row 0 zero) or None when edge_dim == 0.

    Node popularity follows a rank power law p_r ∝ (r+10)^-skew; users and
    items carry latent communities and users pick in-community items 80% of
    the time. The draws and their order are those of the JAX package's
    generator, so both packages see the same stream."""
    rng = np.random.RandomState(seed)
    n_comm = 8

    def popularity(n_pop):
        ranks = np.arange(n_pop, dtype=np.float64)
        p = (ranks + 10.0) ** -skew
        return p / p.sum()

    user_pop = popularity(n_users)
    item_pop = popularity(n_items)
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
            # an empty community falls back to the global item distribution
            items0[sel] = all_items[sel]
            continue
        pc = item_pop[members] / item_pop[members].sum()
        items0[sel] = members[rng.choice(len(members), size=int(sel.sum()), p=pc)]

    users = 1 + users0
    items = 1 + n_users + items0

    gaps = rng.exponential(1.0, n_events)
    timestamps = np.cumsum(gaps)

    edge_idxs = np.arange(1, n_events + 1, dtype=np.int32)
    labels = np.zeros(n_events)
    if label_users_frac > 0:
        flagged = rng.rand(n_users) < label_users_frac
        labels = flagged[users0].astype(np.float64)

    data = Data(users.astype(np.int32), items.astype(np.int32), timestamps,
                edge_idxs, labels)

    edge_feats = None
    if edge_dim > 0:
        edge_feats = rng.randn(n_events + 1, edge_dim).astype(np.float32) * 0.1
        edge_feats[0] = 0.0
    return data, edge_feats
