"""When the train batch replays CUDA graphs (``train/graphs.py``), and the
Trainer's counters of it, on the CPU.

The rule (:func:`replays`) is a function of what the code observes: only a
full streaming train batch on a CUDA device, off the row-sharded path and
without ``debug_nans``, replays; pruning, the other towers, eval, a padded
batch, a row-sharded one, ``debug_nans`` and the CPU run eagerly. On the
CPU every train batch runs eagerly: ``eager_batches`` counts them all,
row-sharded ones too, and ``graph_captures``/``graph_batches`` stay 0.
The graph path itself needs a card: ``tests/test_torch_graphs_card.py``."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.train.graphs import replays
from zebra_tpu_torch.train.loop import Trainer

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
ROWS = torch.zeros(4, 3, 9)           # a superchunk's extraction rows


@pytest.mark.parametrize("case,cfg,train,device,queries,full,expect", [
    ("streaming train", {}, True, CUDA, ROWS, True, True),
    ("seed lanes", dict(parallel_runs=2), True, CUDA, ROWS, True, True),
    ("seeds sharded", dict(parallel_runs=2, n_devices=2), True, CUDA, ROWS,
     True, True),
    ("padded", {}, True, CUDA, ROWS, False, False),
    ("eval", {}, False, CUDA, ROWS, True, False),
    ("pruning", dict(tppr_strategy="pruning"), True, CUDA, object(), True,
     False),
    ("other tower", dict(embedding_module="identity"), True, CUDA, None,
     True, False),
    ("row-sharded", dict(n_devices=2), True, CUDA, ROWS, True, False),
    ("debug_nans", dict(debug_nans=True), True, CUDA, ROWS, True, False),
    ("cpu", {}, True, CPU, ROWS, True, False),
])
def test_replay_rule(case, cfg, train, device, queries, full, expect):
    assert replays(Config(**cfg), train, device, queries, full) is expect


BS, CHUNK = 50, 200


def _trainer(tmp_path, **kw) -> Trainer:
    data, ef = synthetic_stream(n_events=600, n_users=20, n_items=20,
                                edge_dim=4, seed=0)
    cfg = Config(bs=BS, index_chunk=CHUNK, node_dim=8, time_dim=8,
                 memory_dim=8, topk=4, alpha_list=(0.1,), beta_list=(0.9,),
                 checkpoint_dir=str(tmp_path), **kw)
    return Trainer(cfg, split_data(data.sources, data.destinations,
                                   data.timestamps, data.edge_idxs,
                                   data.labels), ef, device="cpu")


@pytest.mark.parametrize("options", [
    {}, dict(parallel_runs=2),
    dict(tppr_strategy="pruning", n_degree=4, n_layer=2)],
    ids=["streaming", "seeds", "pruning"])
def test_cpu_counters(tmp_path, options):
    """Two epochs with a validate between them: every train batch counted
    eager, none captured or replayed, and the epoch reset makes new
    tables (no graph holds any)."""
    tr = _trainer(tmp_path, **options)
    n_batches = tr._streams["train"].n_batches
    tables = tr.mem
    tr.train_epoch()
    tr.validate()
    tr.train_epoch()
    assert (tr.graph_captures, tr.graph_batches) == (0, 0)
    assert tr.eager_batches == 2 * n_batches
    assert tr._graphs.tables() is None and tr.mem is not tables


def test_epoch_reset_keeps_bound_tables(tmp_path):
    """The tables a capture is bound to are zeroed in place at an epoch
    start and stay this Trainer's tables; the metrics are those of a
    Trainer that makes new tables."""
    a, b = _trainer(tmp_path), _trainer(tmp_path)
    a.train_epoch(), b.train_epoch()
    bound = b.mem
    b._graphs.tables = lambda: bound
    a.validate(), b.validate()
    ra, rb = a.train_epoch(), b.train_epoch()
    assert b.mem is bound
    np.testing.assert_array_equal(ra.per_batch, rb.per_batch)
    for x, y in zip(a.mem, b.mem):
        assert torch.equal(x, y)
