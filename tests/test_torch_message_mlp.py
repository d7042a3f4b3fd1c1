"""The mlp message function (``--message_function mlp``) of the port against
the JAX package's: the updater cell reads relu(msg_fc1(raw)) → msg_fc2, a
raw // 2 hidden layer and a memory_dim output, in f32, with torch Linear's
U(±1/√in) init.

Bars:
- ``message_cell_input`` from the same params and inputs (compact and full
  layouts, f32 and bf16 rows, one seed and two stacked lanes): within 1e-6
  relative to the result's largest entry (two f32 products in another
  summation order);
- two train or eval batches of ``run_phase`` (mlp alone, with mean, and
  with mean and both message-source flags): the bars of
  test_torch_aggregator_mean.py.

Port only: ``bridge`` carries ``msg_fc1``/``msg_fc2`` across and back
unchanged, single-seed and stacked; init draws them at JAX's shapes and
law; a state file holds them and their Adam moments, and an epoch resumed
from its middle equals an uninterrupted one bit for bit."""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_aggregator_mean import _cfgs, check_run_phase
from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_train import _params
from zebra_tpu.models import tgn as jtgn
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.models import tgn
from zebra_tpu_torch.train.loop import Trainer

MLP = dict(message_function="mlp", aggregator="last")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", [False, True])
def test_message_cell_input_matches_jax(dtype, source):
    jcfg, cfg = _cfgs(dtype, use_source_embedding_in_message=source, **MLP)
    assert cfg.cell_input_dim == jcfg.cell_input_dim == cfg.memory_dim
    jp, pp = _params(jcfg)
    rng = np.random.RandomState(0)
    raw = rng.randn(30, cfg.msg_table_dim).astype(np.float32)
    rows = rng.randn(30, cfg.memory_dim).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = np.asarray(jtgn.message_cell_input(
        jcfg, jp, jnp.asarray(raw, jd), jnp.asarray(rows, jd)))
    td = getattr(torch, dtype)
    with torch.no_grad():
        got = tgn.message_cell_input(cfg, pp, torch.from_numpy(raw).to(td),
                                     torch.from_numpy(rows).to(td))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_stacked_lanes_match_one_seed_each():
    """Two stacked parameter lanes and [2, n, W] inputs: one batched product
    per layer, each lane as its single-seed call."""
    _, cfg = _cfgs("float32", **MLP)
    lanes = [tgn.init_tgn_params(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in (0, 1)]
    stacked = tgn.stack_params(lanes)
    rng = np.random.RandomState(1)
    raw = torch.from_numpy(rng.randn(2, 30, cfg.msg_table_dim)
                           .astype(np.float32))
    rows = torch.from_numpy(rng.randn(2, 30, cfg.memory_dim)
                            .astype(np.float32))
    with torch.no_grad():
        got = tgn.message_cell_input(cfg, stacked, raw, rows)
        for s in (0, 1):
            want = tgn.message_cell_input(cfg, lanes[s], raw[s], rows[s])
            torch.testing.assert_close(got[s], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,train,kw", [
    ("float32", True, MLP),
    ("float32", False, MLP),
    ("bfloat16", True, MLP),
    ("float32", True, dict(message_function="mlp")),
    ("float32", True, dict(message_function="mlp",
                           use_source_embedding_in_message=True,
                           use_destination_embedding_in_message=True)),
], ids=["train", "eval", "train-bf16", "mean-train", "mean-flags-train"])
def test_run_phase_matches_jax(dtype, train, kw):
    check_run_phase(dtype, train, **kw)


def test_init_and_bridge_round_trip():
    jcfg, cfg = _cfgs("float32", **MLP)
    jp, _ = _params(jcfg)
    port = tgn.init_tgn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    raw = cfg.message_dim
    for name, shape in (("msg_fc1", (raw, raw // 2)),
                        ("msg_fc2", (raw // 2, cfg.memory_dim))):
        w = port[name]["w"]
        assert tuple(w.shape) == shape == np.asarray(jp[name]["w"]).shape
        assert float(w.abs().max()) <= shape[0] ** -0.5     # U(±1/√in)
    tree = jax.tree.map(np.asarray, jp)
    back = bridge.params_to_numpy(bridge.params_from_numpy(tree, "cpu"))
    assert set(back) == set(tree)
    for name in ("msg_fc1", "msg_fc2", "cell"):
        for key, v in tree[name].items():
            np.testing.assert_array_equal(back[name][key], v)
    stacked = jax.tree.map(lambda *x: np.stack(x), tree, tree)
    back = bridge.params_to_numpy(bridge.params_from_numpy(stacked, "cpu"))
    np.testing.assert_array_equal(back["msg_fc2"]["b"],
                                  stacked["msg_fc2"]["b"])
    assert back["msg_fc1"]["w"].shape == (2, raw, raw // 2)


def _trainer(tmp_path, **kw):
    data, ef = synthetic_stream(600, 30, 30, edge_dim=4, seed=0)
    splits = split_data(data.sources, data.destinations, data.timestamps,
                        data.edge_idxs, data.labels)
    cfg = Config(bs=50, index_chunk=100, node_dim=8, time_dim=8,
                 memory_dim=8, topk=4, alpha_list=(0.1, 0.1),
                 beta_list=(0.05, 0.95), lr=3e-3, message_function="mlp",
                 checkpoint_dir=str(tmp_path), **kw)
    return Trainer(cfg, splits, ef, device="cpu")


ALL = dict(aggregator="mean", use_source_embedding_in_message=True,
           use_destination_embedding_in_message=True)


@pytest.mark.parametrize("kw", [{}, ALL], ids=["mlp", "all-options"])
def test_state_file_resumes_an_epoch_exactly(tmp_path, kw):
    """A state file written after the first superchunk of an epoch (the
    msg_fc weights and their Adam moments, the message table at its width,
    msg_count) resumes to the uninterrupted epoch's results bit for bit."""
    full = _trainer(tmp_path, **kw)
    ref = full.train_epoch()
    part = _trainer(tmp_path, **kw)
    part.train_epoch(max_chunks=1)
    path = str(tmp_path / "mid.state.ckpt")
    part.save_state(path)
    resumed = _trainer(tmp_path, **kw)
    assert resumed.restore_state(path) == (0, 1)
    names = list(resumed.params.state_dict())
    got = resumed.optimizer.state_dict()["state"]
    want = part.optimizer.state_dict()["state"]
    for i in (names.index("msg_fc1.w"), names.index("msg_fc2.b")):
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][moment], want[i][moment])
            assert float(got[i][moment].abs().sum()) > 0
    rest = resumed.train_epoch(start_chunk=1)
    np.testing.assert_array_equal(rest.per_batch,
                                  ref.per_batch[-len(rest.per_batch):])
    for a, b in zip(resumed.mem, full.mem):
        assert torch.equal(a, b)
    for key, v in full.params.state_dict().items():
        assert torch.equal(resumed.params.state_dict()[key], v), key
    assert resumed.mem.messages.shape[1] == resumed.cfg.msg_table_dim + 1
