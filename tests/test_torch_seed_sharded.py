"""The port's seed-sharded run (``parallel_runs`` S = 4 over ``n_devices`` D
= 2 ranks, two whole seeds per rank, zebra_tpu_torch/parallel/) against the
port's one-process S-seed run and against the JAX package's seed-sharded
Trainer on the conftest's virtual mesh, at the sizes of
test_torch_seed_trainer.py. The ranks run on the CPU in one spawned Gloo
group per module (tests/torch_rank_worker.py).

Bars:
- the index: bit-equal on both ranks and to the one-process run (it
  depends only on the stream), after the train epoch and after test;
- each lane's train negatives: bit-equal to the one-process run's;
- each lane's loss, AP, AUC and accuracy per batch of every phase within
  1e-6 of the one-process run and of JAX ``Trainer(parallel_runs=4,
  n_devices=2)`` from the same stacked params (dropout 0, f32 tables, lr
  1e-3), memory within 1e-4: test_torch_seed_trainer.py's bars. A lane in
  a group of two is not bit-equal to the same lane in a group of four (a
  batched product sums in an order that depends on the batch);
- ``fit`` per seed against sequential single-seed port fits: test AP
  within 5e-3 and the same stop epoch (tests/test_seed_sharded.py:110-131)."""

import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.torch_rank_worker import (
    F32,
    FIT,
    PHASES,
    SMALL,
    S,
    run_group,
    run_phases,
    trainer,
)
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream as jax_stream
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge

FIELDS = ("loss", "ap", "auc", "acc")
METRIC_ATOL, MEMORY_ATOL, FIT_ATOL = 1e-6, 1e-4, 5e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results per scenario, one-process port results, JAX phase
    results and memory)."""
    tmp = tmp_path_factory.mktemp("sharded")
    data, ef = jax_stream(n_events=1200, n_users=40, n_items=40, edge_dim=4,
                          seed=0)
    jcfg = JaxConfig(**SMALL, **F32, dropout=0.0, parallel_runs=S,
                     n_devices=2, checkpoint_dir=str(tmp / "jax"))
    jt = JaxTrainer(jcfg, jax_split_data(
        data.sources, data.destinations, data.timestamps, data.edge_idxs,
        data.labels), ef)
    assert jt._mesh is not None and jt._mesh.devices.size == 2
    params = jax.tree.map(np.asarray, jt.params)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    # the ranks run while this process runs JAX and the one-process port
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(run_group, ["lanes", "fit"], tmp)
        one = trainer(str(tmp / "one"), parallel_runs=S, dropout=0.0, **F32)
        bridge.load_trainer_params(one, params)
        port = dict(run_phases(one), negs=one._draw_train_negs(0))
        tr = jt.train_epoch()
        val, nn_val = jt.validate()
        test, nn_test = jt.test()
        jres = dict(zip(PHASES, (tr, val, nn_val, test, nn_test)))
        ranks = group.result()
    return ranks, port, jres, jax.tree.map(np.asarray, jt.mem)


def _gathered(ranks, key):
    """The ranks' lanes of tables ``key`` stacked in global lane order."""
    return {k: np.concatenate([bridge.to_numpy(r[key][k]) for r in ranks])
            for k in ranks[0][key]}


def test_ranks_hold_whole_seeds(runs):
    ranks = runs[0]["lanes"]
    assert [r["lanes"] for r in ranks] == [[0, 1], [2, 3]]
    for r in ranks:
        assert r["mem"]["memory"].shape[0] == 2
        assert r["params"]["fc1.w"].shape[0] == 2
        assert r["per_batch"]["train"].shape[1:] == (S, 4)


@pytest.mark.parametrize("when", ["train_index", "index"])
def test_index_bit_equal_on_ranks_and_to_one_process(runs, when):
    ranks, port = runs[0]["lanes"], runs[1]
    for r in ranks:
        np.testing.assert_array_equal(r[when].numpy(), port[when].numpy())


def test_lane_negatives_equal_one_process(runs):
    ranks, port = runs[0]["lanes"], runs[1]
    np.testing.assert_array_equal(
        np.concatenate([r["negs"] for r in ranks]), port["negs"])
    np.testing.assert_array_equal(
        np.concatenate([r["neg_base"] for r in ranks]), port["neg_base"])


@pytest.mark.parametrize("phase", PHASES)
def test_lanes_match_one_process(runs, phase):
    ranks, port = runs[0]["lanes"], runs[1]
    for r in ranks:   # every rank holds every lane's metrics
        np.testing.assert_allclose(r["per_batch"][phase],
                                   port["per_batch"][phase], rtol=0,
                                   atol=METRIC_ATOL)


@pytest.mark.parametrize("phase", PHASES)
def test_lanes_match_jax_seed_sharded(runs, phase):
    ranks, jres = runs[0]["lanes"], runs[2]
    per_batch = ranks[0]["per_batch"][phase]
    for i, f in enumerate(FIELDS):
        got = per_batch[..., i].mean(0)
        want = np.asarray(getattr(jres[phase], f))
        assert got.shape == want.shape == (S,)
        np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ATOL,
                                   err_msg=f)


@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_lane_memory_matches(runs, against):
    ranks, port, _, jmem = runs
    got = _gathered(ranks["lanes"], "mem")
    want = ({k: bridge.to_numpy(v) for k, v in port["mem"].items()}
            if against == "one_process" else
            {f: np.asarray(getattr(jmem, f), np.float32)
             for f in jmem._fields})
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v, want[k], rtol=0, atol=MEMORY_ATOL,
                                   err_msg=k)


def test_fit_matches_sequential_single_seed_runs(runs, tmp_path):
    ranks = runs[0]["fit"]
    out = ranks[0]["results"]
    assert ranks[1]["results"] == out     # every rank decides alike
    for s in range(S):
        single = trainer(str(tmp_path / f"s{s}"), 600, FIT, seed=s).fit()
        for k in ("test_ap", "nn_test_ap"):
            assert abs(out["per_seed"][k][s] - single[k]) <= FIT_ATOL, (k, s)
        assert out["per_seed"]["stop_epoch"][s] == single["stop_epoch"]
    assert out["per_seed"]["lr"] == [FIT["lr"]] * S
