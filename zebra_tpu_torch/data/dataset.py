"""Event-stream containers and the chronological/inductive split (numpy copy
of ``zebra_tpu/data/dataset.py``: the same inputs give identical splits).

70/15/15 chronological split at the timestamp quantiles, plus an inductive
holdout of 10% of the nodes active after the validation cut, drawn with
``random.Random(2020)``; the training edges touching a held-out node are
dropped, and the "new-node" val/test sets are the val/test edges touching a
node unseen in training. Node ids are 1-based (0 is padding), edge ids
1-based (0 is the zero feature row)."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class Data:
    """One chronological slice of a stream: parallel event arrays."""

    sources: np.ndarray
    destinations: np.ndarray
    timestamps: np.ndarray
    edge_idxs: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        self.sources = np.asarray(self.sources, dtype=np.int32)
        self.destinations = np.asarray(self.destinations, dtype=np.int32)
        self.timestamps = np.asarray(self.timestamps, dtype=np.float64)
        self.edge_idxs = np.asarray(self.edge_idxs, dtype=np.int32)
        self.labels = np.asarray(self.labels)

    @property
    def n_interactions(self) -> int:
        return len(self.sources)


@dataclass
class DatasetSplits:
    full: Data
    train: Data
    val: Data
    test: Data
    new_node_val: Data
    new_node_test: Data
    n_nodes: int  # the largest node id, or the unique-node count if larger
    n_edges: int  # number of interactions in the full stream


def split_data(sources, destinations, timestamps, edge_idxs, labels,
               new_node_seed: int = 2020,
               quantiles: Tuple[float, float] = (0.70, 0.85)) -> DatasetSplits:
    """Chronological 70/15/15 split with the inductive new-node holdout, in
    the JAX package's order of operations and draws."""
    sources = np.asarray(sources)
    destinations = np.asarray(destinations)
    timestamps = np.asarray(timestamps)
    edge_idxs = np.asarray(edge_idxs)
    labels = np.asarray(labels)

    val_time, test_time = list(np.quantile(timestamps, quantiles))
    node_set = set(sources.tolist()) | set(destinations.tolist())
    n_total_unique_nodes = len(node_set)

    # hold out 10% of all nodes from those active after the validation cut;
    # sampling from the sorted list makes the draw reproducible
    late = timestamps > val_time
    test_node_set = set(sources[late].tolist()) | set(destinations[late].tolist())
    new_test_node_set = set(random.Random(new_node_seed).sample(
        sorted(test_node_set), int(0.1 * n_total_unique_nodes)))

    held = lambda ids: np.fromiter((v in new_test_node_set for v in ids.tolist()),
                                   bool, len(ids))
    observed = ~held(sources) & ~held(destinations)

    def take(mask) -> Data:
        return Data(sources[mask], destinations[mask], timestamps[mask],
                    edge_idxs[mask], labels[mask])

    train = take((timestamps <= val_time) & observed)
    train_node_set = set(train.sources.tolist()) | set(train.destinations.tolist())
    if train_node_set & new_test_node_set:
        raise AssertionError("a held-out node appears in the train split")

    # any node not seen in training counts as new
    new_node_set = node_set - train_node_set
    val_mask = (timestamps <= test_time) & (timestamps > val_time)
    test_mask = timestamps > test_time
    touches_new = np.fromiter(
        ((a in new_node_set or b in new_node_set)
         for a, b in zip(sources.tolist(), destinations.tolist())),
        bool, len(sources))

    # tables are sized by the largest id present, so sparse id spaces
    # cannot index out of bounds
    max_id = int(max(sources.max(), destinations.max()))
    return DatasetSplits(
        full=Data(sources, destinations, timestamps, edge_idxs, labels),
        train=train,
        val=take(val_mask),
        test=take(test_mask),
        new_node_val=take(val_mask & touches_new),
        new_node_test=take(test_mask & touches_new),
        n_nodes=max(max_id, n_total_unique_nodes),
        n_edges=len(sources),
    )
