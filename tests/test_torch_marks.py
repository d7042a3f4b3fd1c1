"""The marks of a train superchunk (``Trainer.train_epoch(marks=...)``,
the recorder of ``zebra_tpu_torch/utils/profiling.py``): their names, in
order, on every path of the train batch, on the CPU with the recorder's
event factory a stand-in. A mark ends each part of each batch and the
wave scan, after a ``start`` mark: the BFS (``query``, pruning), then
forward, backward, adam, protocol and metrics; a row-sharded batch (two
CPU ranks, tests/torch_rank_worker.py's ``sc_rows_marks``) fetches its
block's rows, sums the gradients over the ranks and sends the rows it
wins in place of the metrics."""

import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.torch_rank_worker import run_group
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.utils import profiling

BS, CHUNK = 50, 200
N_BATCHES = CHUNK // BS
PARTS = ["forward", "backward", "adam", "protocol", "metrics"]
ROW_PARTS = ["fetch", "forward", "backward", "allreduce", "adam", "protocol",
             "send"]
PATHS = {
    "streaming": ({}, ["start", "wave_scan"] + PARTS * N_BATCHES),
    "pruning": (dict(tppr_strategy="pruning", n_degree=4, n_layer=2),
                ["start"] + (["query"] + PARTS) * N_BATCHES),
    "identity": (dict(embedding_module="identity"),
                 ["start"] + PARTS * N_BATCHES),
    "recursive": (dict(embedding_module="graph_attention", n_degree=3,
                       n_layer=1), ["start"] + PARTS * N_BATCHES),
}
ROWS = {
    "streaming": ["start", "wave_scan"] + ROW_PARTS * N_BATCHES,
    "pruning": ["start"] + (["query"] + ROW_PARTS) * N_BATCHES,
}


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    return run_group(["rows_marks"],
                     tmp_path_factory.mktemp("rows_marks"))["rows_marks"]


def _trainer(tmp_path, **kw) -> Trainer:
    data, ef = synthetic_stream(n_events=600, n_users=20, n_items=20,
                                edge_dim=4, seed=0)
    cfg = Config(bs=BS, index_chunk=CHUNK, node_dim=8, time_dim=8,
                 memory_dim=8, topk=4, alpha_list=(0.1,), beta_list=(0.9,),
                 checkpoint_dir=str(tmp_path), **kw)
    return Trainer(cfg, split_data(data.sources, data.destinations,
                                   data.timestamps, data.edge_idxs,
                                   data.labels), ef, device="cpu")


@pytest.mark.parametrize("path", list(PATHS) + [f"rows_{p}" for p in ROWS])
def test_train_superchunk_marks(tmp_path, monkeypatch, request, path):
    if path.startswith("rows_"):
        name = path[len("rows_"):]
        for got in request.getfixturevalue("rows"):   # each rank's
            assert got[name] == ROWS[name]
        return
    kw, want = PATHS[path]
    tr = _trainer(tmp_path, **kw)
    monkeypatch.setattr(profiling, "mark_event", object)
    marks: list = []
    tr.train_epoch(max_chunks=1, marks=marks)
    assert [name for name, _ in marks] == want
    assert profiling._marks is None     # disarmed after the call


def test_unarmed_records_nothing(tmp_path, monkeypatch):
    """Without ``marks`` the recorder stays unarmed: a part is its span
    alone and no event is made."""
    def refuse():
        raise AssertionError("an event without marks")

    tr = _trainer(tmp_path)
    monkeypatch.setattr(profiling, "mark_event", refuse)
    assert profiling.part(profiling.FORWARD) is profiling.NO_SPAN
    tr.train_epoch(max_chunks=1)
