"""The train batch's CUDA graphs (``train/graphs.py``) against the eager
path, on the card: ``python3 -m pytest --noconftest -m card
tests/test_torch_graphs_card.py`` (the package's conftest loads JAX, which
the card's machine does not hold). Each test skips without a CUDA device.

Two Trainers of one stream, weights, seed and dropout 0.1 run the same
calls, one with the graphs and one switched to the eager path (its private
``_graphs`` set to None). Bit-equal after every call: the per-batch
metrics rows (losses among them), the parameters, Adam's moments and step
counts, the memory tables, the index and the dropout generators' states.
Cases: one seed over two epochs with ``validate`` between them (one
capture for both epochs; the padded tail of each epoch eager); three seed
lanes (``SeedAdam``); ``set_params`` after a capture, then a new epoch
(one more capture, the replays on the new parameters); a state file
restored mid-epoch (new tables: one more capture); and the model options
whose protocol and forward differ (``mean``, ``mlp``, both message-source
flags, the lazy compaction)."""

import numpy as np
import pytest
import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.models.tgn import init_tgn_params
from zebra_tpu_torch.train.loop import Trainer

pytestmark = pytest.mark.card

# 4,830 train events: 25 batches of 200 in superchunks of 1,000 events
# (the last batch holds 30 events)
N_EVENTS, BS, CHUNK = 6_900, 200, 1_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(tmp_path, card, **kw):
    """(graph Trainer, eager Trainer) on one stream and config."""
    data, ef = synthetic_stream(N_EVENTS, 300, 300, edge_dim=16, seed=3)
    splits = split_data(data.sources, data.destinations, data.timestamps,
                        data.edge_idxs, data.labels)
    out = []
    for name in ("graphs", "eager"):
        cfg = Config(bs=BS, index_chunk=CHUNK, node_dim=32, time_dim=32,
                     memory_dim=32, topk=10, alpha_list=(0.1, 0.1),
                     beta_list=(0.5, 0.95), dropout=0.1, seed=7,
                     checkpoint_dir=str(tmp_path / name), **kw)
        out.append(Trainer(cfg, splits, ef, device=card))
    out[1]._graphs = None
    return out


def _moments(opt) -> list:
    if hasattr(opt, "exp_avg"):
        return opt.exp_avg + opt.exp_avg_sq + [torch.tensor(opt.steps)]
    state = opt.state_dict()["state"]
    return [t for k in sorted(state) for t in (
        state[k]["exp_avg"], state[k]["exp_avg_sq"], state[k]["step"])]


def _same(g: Trainer, e: Trainer, *results) -> None:
    for rg, re in results:
        np.testing.assert_array_equal(rg.per_batch, re.per_batch)
    pairs = [("params", list(g.params.state_dict().values()),
              list(e.params.state_dict().values())),
             ("adam", _moments(g.optimizer), _moments(e.optimizer)),
             ("memory", list(g.mem), list(e.mem)),
             ("generators", [x.get_state() for x in g._generators()],
              [x.get_state() for x in e._generators()])]
    if g.index_state is not None:
        pairs.append(("index", [g.index_state.data], [e.index_state.data]))
    for what, xs, ys in pairs:
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert torch.equal(x.cpu(), y.cpu()), what


def _full_batches(tr: Trainer):
    n_valid = tr._streams["train"].n_valid()
    return int((n_valid == tr.cfg.bs).sum()), int((n_valid < tr.cfg.bs).sum())


def _epoch(g, e):
    rg, re = g.train_epoch(), e.train_epoch()
    torch.cuda.synchronize()
    _same(g, e, (rg, re))


def test_one_seed_two_epochs_with_validate(tmp_path, card):
    g, e = _pair(tmp_path, card)
    full, tail = _full_batches(g)
    assert tail >= 1
    _epoch(g, e)
    _same(g, e, *zip(g.validate(), e.validate()))
    _epoch(g, e)
    assert (g.graph_captures, g.graph_batches, g.eager_batches) == (
        1, 2 * full, 2 * tail)


def test_seed_lanes(tmp_path, card):
    g, e = _pair(tmp_path, card, parallel_runs=3,
                 parallel_lr=(1e-4, 3e-4, 1e-3))
    _epoch(g, e)
    _same(g, e, *zip(g.validate(), e.validate()))
    _epoch(g, e)
    assert g.graph_captures == 1


def test_set_params_after_capture(tmp_path, card):
    g, e = _pair(tmp_path, card)
    _epoch(g, e)
    for tr in (g, e):
        tr.set_params(init_tgn_params(
            tr.cfg, torch.Generator().manual_seed(11), card))
    before = [p.detach().clone() for p in g.params.parameters()]
    _epoch(g, e)
    assert g.graph_captures == 2
    assert all(not torch.equal(a, b)
               for a, b in zip(before, g.params.parameters()))


def test_restored_state_mid_epoch(tmp_path, card):
    g, e = _pair(tmp_path, card)
    for tr in (g, e):
        tr.train_epoch(max_chunks=2)
        tr.save_state(str(tmp_path / f"{id(tr)}.state"))
        tr.train_epoch(start_chunk=2)
        tr.restore_state(str(tmp_path / f"{id(tr)}.state"))
    rg, re = g.train_epoch(start_chunk=2), e.train_epoch(start_chunk=2)
    torch.cuda.synchronize()
    _same(g, e, (rg, re))
    assert g.graph_captures == 2


def test_model_options(tmp_path, card):
    g, e = _pair(tmp_path, card, aggregator="mean", message_function="mlp",
                 use_source_embedding_in_message=True,
                 use_destination_embedding_in_message=True,
                 lazy_unique_cap=-1)
    _epoch(g, e)
    _same(g, e, *zip(g.validate(), e.validate()))
    _epoch(g, e)
    assert g.graph_captures >= 1 and g.graph_batches > 0
