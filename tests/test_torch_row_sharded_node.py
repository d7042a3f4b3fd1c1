"""``--task node`` on a row-sharded Trainer (one seed over D = 2 CPU ranks,
tests/torch_rank_worker.py's ``sc_rows_node``). As JAX's replay runs on one
device whatever the mesh (``zebra_tpu/train/node_classification.py:
188-191``), every rank replays train → val → test at full N from fresh
tables with the replicated params and its streams, through one-process
waves and no exchange, so every rank computes the same AUCs.

Bars: the replay's source embeddings from JAX's params within 1e-5 of
JAX's replay after a two-device Trainer (test_torch_node_classification
.py's bar), on both ranks; after a train epoch, both ranks' AUCs equal to
each other and to a one-process replay from the same params; the CLI's
``--n_devices 2 --task node`` on two local ranks reports the node AUCs."""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_cli import _argv, _toy
from tests.torch_rank_worker import (
    F32,
    NODE_LABELS,
    NODE_STEPS,
    OPTION_LR,
    SMALL,
    option_trainer,
    run_group,
    splits,
)
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream as jax_stream
from zebra_tpu.train import node_classification as jnc
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu.train.loop import _fresh_epoch_state
from zebra_tpu_torch import cli
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.train import memory_budget as mb
from zebra_tpu_torch.train.node_classification import run_node_classification

STREAMS = ("train", "val", "test")


def _jax_replay(jt) -> dict:
    """JAX's replay of the three streams from a fresh one-device state
    (its run_node_classification's), the valid events' embeddings."""
    mem, index = _fresh_epoch_state(jt.cfg)
    mem = jax.tree.map(jnp.asarray, mem)
    out = {}
    for name in STREAMS:
        js = jt._streams[name]
        mem, index, e = jnc.collect_source_embeddings(
            jt.cfg, js.n_batches, jt.params, mem, index, jt.edge_feats, (),
            js.stream)
        valid = np.asarray(jt._host_streams[name]["valid"])
        out[name] = np.asarray(e).reshape(-1, jt.cfg.hidden_dim)[valid]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rows_node")
    data, ef = jax_stream(n_events=1200, n_users=40, n_items=40, edge_dim=4,
                          seed=0, label_users_frac=NODE_LABELS)
    jcfg = JaxConfig(**{**SMALL, **F32, "lr": OPTION_LR}, dropout=0.0,
                     n_devices=2, task="node",
                     checkpoint_dir=str(tmp / "jax"))
    jt = JaxTrainer(jcfg, jax_split_data(
        data.sources, data.destinations, data.timestamps, data.edge_idxs,
        data.labels), ef)
    assert jt._mesh is not None
    with open(tmp / "node_params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jt.params), f)
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(run_group, ["rows_node"], tmp)
        jembs = _jax_replay(jt)
        ranks = group.result()["rows_node"]
    # one process replays from the ranks' trained params
    one = option_trainer(str(tmp), "node", 1,
                         label_users_frac=NODE_LABELS)
    one.params.load_state_dict(ranks[0]["params"])
    return ranks, jembs, run_node_classification(one, n_steps=NODE_STEPS)


@pytest.mark.parametrize("stream", STREAMS)
def test_replay_embeddings_match_jax(runs, stream):
    ranks, jembs, _ = runs
    for r in ranks:
        got = r["embs"][stream].numpy()
        assert got.shape == jembs[stream].shape and np.abs(got).max() > 0
        np.testing.assert_allclose(got, jembs[stream], rtol=0, atol=1e-5)


def test_ranks_hold_half_the_rows_and_replay_all(runs):
    for r in runs[0]:
        assert r["local_rows"] == 64
        assert r["embs"]["train"].shape[0] == len(
            splits()[0].train.sources)


def test_aucs_equal_across_ranks_and_one_process(runs):
    ranks, _, one = runs
    assert all(np.isfinite(v) for v in one.values())
    assert ranks[0]["aucs"] == ranks[1]["aucs"] == one


def test_cli_two_local_ranks_task_node(tmp_path):
    """``--n_devices 2 --task node --device cpu`` with one seed: the ranks
    the command starts train, test and replay; rank 0 reports the AUCs."""
    _toy(tmp_path, labels=True)
    (trainer_, res), = cli.main(_argv(tmp_path, "toy", "--n_epoch", "1",
                                      "--n_devices", "2", "--task", "node"))
    assert trainer_ is None
    assert {"node_train_auc", "node_val_auc", "node_test_auc"} <= set(res)
    logs = os.listdir(tmp_path / "log" / "toy")
    text = (tmp_path / "log" / "toy" / logs[0]).read_text()
    assert "row exchange: 2 ranks" in text
    assert "node classification auc" in text


def test_guard_counts_the_full_replay():
    """A row-sharded rank of ``--task node`` also holds the replay's fresh
    tables and index at full N."""
    cfg = Config(**SMALL, task="node").replace(n_nodes=128, edge_dim=4)
    want = 128 * mb.row_bytes(cfg) + mb.index_bytes(cfg)
    assert mb.replay_bytes(cfg, 2) == want > 0
    assert mb.replay_bytes(cfg, 1) == 0
    assert mb.replay_bytes(cfg.replace(task="link"), 2) == 0
