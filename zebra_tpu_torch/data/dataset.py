"""Event-stream containers, the chronological/inductive split and the
loaders of preprocessed datasets (numpy copy of ``zebra_tpu/data/dataset.py``:
the same inputs give identical splits; no pandas).

70/15/15 chronological split at the timestamp quantiles, plus an inductive
holdout of 10% of the nodes active after the validation cut, drawn with
``random.Random(2020)``; the training edges touching a held-out node are
dropped, and the "new-node" val/test sets are the val/test edges touching a
node unseen in training. Node ids are 1-based (0 is padding), edge ids
1-based (0 is the zero feature row)."""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Optional, Tuple

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


ML_COLUMNS = ("u", "i", "ts", "label", "idx")


def read_ml_csv(path: str) -> dict:
    """The columns of an ``ml_{name}.csv`` by header name (``u``, ``i``,
    ``ts``, ``label``, ``idx``): int64 ids, float64 times and labels. Reads
    the file ``DataFrame.to_csv`` writes (a leading unnamed index column)
    and one without that column alike."""
    with open(path) as f:
        header = [h.strip() for h in f.readline().split(",")]
    missing = [c for c in ML_COLUMNS if c not in header]
    if missing:
        raise ValueError(f"{path}: no column {missing} in header {header}")
    table = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2,
                       dtype=np.float64)
    cols = {c: table[:, header.index(c)] for c in ML_COLUMNS}
    for c in ("u", "i", "idx"):
        cols[c] = cols[c].astype(np.int64)
    return cols


def get_data(dataset_name: str, data_dir: str = "data") -> DatasetSplits:
    """Load ``{data_dir}/{name}/ml_{name}.csv`` and split it."""
    cols = read_ml_csv(os.path.join(data_dir, dataset_name,
                                    f"ml_{dataset_name}.csv"))
    return split_data(cols["u"], cols["i"], cols["ts"], cols["idx"],
                      cols["label"])


def load_feat(dataset_name: str, data_dir: str = "data"
              ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The optional node and edge feature matrices
    (``ml_{name}_node.npy``, ``ml_{name}.npy``). Row 0 of the edge features
    is the zero padding row the preprocessor prepends."""
    base = os.path.join(data_dir, dataset_name, f"ml_{dataset_name}")
    load = lambda p: np.load(p) if os.path.exists(p) else None
    return load(base + "_node.npy"), load(base + ".npy")


def compute_time_statistics(sources, destinations, timestamps):
    """Mean and std of the gaps between a node's consecutive events, for
    sources and for destinations (the reference's statistics for
    JODIE-style Δt normalisation; the training path does not use them)."""
    timestamps = np.asarray(timestamps, np.float64)

    def gaps(nodes):
        last = {}
        out = np.empty(len(timestamps))
        for k, (v, t) in enumerate(zip(np.asarray(nodes).tolist(),
                                       timestamps.tolist())):
            out[k] = t - last.get(v, 0.0)
            last[v] = t
        return out

    ds, dd = gaps(sources), gaps(destinations)
    return float(ds.mean()), float(ds.std()), float(dd.mean()), float(dd.std())
