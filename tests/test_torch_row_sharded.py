"""The port's row-sharded run (one seed, its node rows over ``n_devices``
D = 2 CPU ranks: zebra_tpu_torch/parallel/exchange.py, train/phase.py:
run_phase_rows) against the port's one-process run and against the JAX
package's ``Trainer(n_devices=2)`` on the conftest's virtual mesh, which
row-shards the same tables (``shard_memory``, ``shard_index_state``), at
the sizes of test_torch_seed_trainer.py: 1,200 events, 40 + 40 nodes (128
padded rows, 64 per rank), bs 50 (25 events per rank), dims 16, top-5,
the flagship (α, β). The ranks run in one spawned Gloo group per module
(tests/torch_rank_worker.py).

Bars, from JAX's params (dropout 0, f32 tables):
- the index, gathered from the ranks, after the train epoch and after
  test: bit-equal to the one-process port's; against JAX's row-sharded
  index the merge bar of test_torch_merge.py, the repo's bar between the
  two packages' indices (XLA on the CPU contracts a multiply-add, which
  moves a weight by an ulp; JAX's two devices are bit-equal to its one,
  tests/test_multichip.py:25-33, as the port's two ranks are to its one);
- the per-batch loss, AP, AUC and accuracy of every phase within 1e-6 of
  the one-process port (a block's products and the gradient's sum over
  two ranks round in another order: 2.4e-7 measured), and JAX's phase
  means within 1e-6 (eval) and 1e-5 (the train epoch);
- the memory tables after the train epoch and at the end within 1e-6 of
  the one-process port, and within test_torch_seed_sharded.py's 1e-4 of
  JAX's (XLA's products against the CPU's BLAS through an epoch);
- the params bit-equal across the ranks.
With dropout 0.1 and f32 tables the ranks draw the one-process run's
masks: the first superchunk's train losses within 1e-6. Both backup
protocols give bit-equal results."""

import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from tests.torch_rank_worker import (
    F32,
    PHASES,
    SMALL,
    run_group,
    trainer,
)
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream as jax_stream
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.models.tgn import BlockMasks, _dropout_keep

FIELDS = ("loss", "ap", "auc", "acc")
PORT_ATOL, JAX_EVAL_ATOL, JAX_TRAIN_ATOL = 1e-6, 1e-6, 1e-5
JAX_MEMORY_ATOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results per scenario, one-process port results, JAX phase
    results, memory and index)."""
    tmp = tmp_path_factory.mktemp("rows")
    data, ef = jax_stream(n_events=1200, n_users=40, n_items=40, edge_dim=4,
                          seed=0)
    jcfg = JaxConfig(**SMALL, **F32, dropout=0.0, n_devices=2,
                     checkpoint_dir=str(tmp / "jax"))
    jt = JaxTrainer(jcfg, jax_split_data(
        data.sources, data.destinations, data.timestamps, data.edge_idxs,
        data.labels), ef)
    assert jt._mesh is not None and jt._mesh.devices.size == 2
    params = jax.tree.map(np.asarray, jt.params)
    with open(tmp / "rows_params.pkl", "wb") as f:
        pickle.dump(params, f)
    # the ranks run while this process runs JAX and the one-process port
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(run_group, ["rows_jax", "rows_dropout",
                                        "rows_host_backup"], tmp)
        one = trainer(str(tmp / "one"), dropout=0.0, **F32)
        bridge.load_trainer_params(one, params)
        tr = one.train_epoch()
        port = dict(train_index=one.index_state.data.clone(),
                    train_mem={k: v.clone() for k, v in
                               one.mem._asdict().items()})
        phases = (tr, *one.validate(), *one.test())
        port.update(per_batch={p: r.per_batch for p, r in zip(PHASES,
                                                              phases)},
                    index=one.index_state.data.clone(),
                    mem={k: v.clone() for k, v in one.mem._asdict().items()},
                    negs=one._draw_train_negs(0), neg_base=one._neg_base)
        masked = trainer(str(tmp / "one_dropout"), **F32)
        ports = dict(jax=port, dropout=dict(
            per_batch=masked.train_epoch(max_chunks=1).per_batch))
        jtr = jt.train_epoch()
        jtrain_index = np.asarray(jt.index_state.data)
        jtrain_mem = jax.tree.map(np.asarray, jt.mem)
        jphases = (jtr, *jt.validate(), *jt.test())
        jres = dict(phases=dict(zip(PHASES, jphases)),
                    train_index=jtrain_index,
                    index=np.asarray(jt.index_state.data),
                    train_mem=jtrain_mem,
                    mem=jax.tree.map(np.asarray, jt.mem))
        ranks = group.result()
    return ranks, ports, jres


def test_ranks_hold_half_the_rows_each(runs):
    for r in runs[0]["rows_jax"]:
        assert r["local_rows"] == 64 and r["backend"] == "gloo"
        assert r["mem"]["memory"].shape[0] == 128   # gathered
        # a wave's fetch, a batch's fetch and send, the gradients, the
        # scores: every kind of exchange ran
        assert set(r["stats"]) == {"wave", "tower_fetch", "tower_send",
                                   "grad", "scores"}


@pytest.mark.parametrize("when", ["train_index", "index"])
@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_index_matches(runs, when, against):
    ranks, ports, jres = runs
    m, k = len(SMALL["alpha_list"]), SMALL["topk"]
    for r in ranks["rows_jax"]:
        got = r[when].numpy()
        if against == "one_process":
            np.testing.assert_array_equal(got, ports["jax"][when].numpy())
            continue
        split = lambda a: (a[:, : 4 * m * k].reshape(-1, m, 4, k),
                           a[:, 4 * m * k:])
        assert_entries_close(*split(got), *split(jres[when]))


def test_negatives_equal_one_process(runs):
    ranks, ports, _ = runs
    for r in ranks["rows_jax"]:
        np.testing.assert_array_equal(r["negs"], ports["jax"]["negs"])
        assert r["neg_base"] == ports["jax"]["neg_base"]


@pytest.mark.parametrize("phase", PHASES)
def test_metrics_match_one_process(runs, phase):
    ranks, ports, _ = runs
    for r in ranks["rows_jax"]:   # every rank holds every batch's metrics
        np.testing.assert_allclose(r["per_batch"][phase],
                                   ports["jax"]["per_batch"][phase], rtol=0,
                                   atol=PORT_ATOL)


@pytest.mark.parametrize("phase", PHASES)
def test_metrics_match_jax_row_sharded(runs, phase):
    ranks, _, jres = runs
    per_batch = ranks["rows_jax"][0]["per_batch"][phase]
    atol = JAX_TRAIN_ATOL if phase == "train" else JAX_EVAL_ATOL
    for i, f in enumerate(FIELDS):
        got = float(per_batch[:, i].mean())
        want = float(getattr(jres["phases"][phase], f))
        assert abs(got - want) <= atol, (f, got, want)


@pytest.mark.parametrize("when", ["train_mem", "mem"])
@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_memory_matches(runs, when, against):
    ranks, ports, jres = runs
    got = {k: bridge.to_numpy(v) for k, v in ranks["rows_jax"][0][when]
           .items()}
    if against == "one_process":
        want = {k: bridge.to_numpy(v) for k, v in ports["jax"][when].items()}
        atol = PORT_ATOL
    else:
        want = {f: np.asarray(getattr(jres[when], f), np.float32)
                for f in jres[when]._fields}
        atol = JAX_MEMORY_ATOL
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v, want[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("scenario", ["rows_jax", "rows_dropout"])
def test_params_bit_equal_across_ranks(runs, scenario):
    r0, r1 = runs[0][scenario]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k


def test_dropout_masks_are_the_one_process_runs(runs):
    """With dropout 0.1 the ranks' first superchunk trains as one process
    does: the masks of a block are the whole batch's, sliced."""
    ranks, ports, _ = runs
    want = ports["dropout"]["per_batch"][:, 0]
    for r in ranks["rows_dropout"]:
        got = r["per_batch"][:, 0]
        assert got.shape == want.shape == (4,)
        np.testing.assert_allclose(got, want, rtol=0, atol=PORT_ATOL)


@pytest.mark.parametrize("row_axis,shape", [(-2, (12, 5)),
                                            (-3, (2, 12, 3, 5))])
def test_block_masks_slice_the_whole_batch(row_axis, shape):
    """A block's keep mask equals rows of the whole batch's, and draws as
    much from the generator."""
    rows = torch.tensor([3, 4, 9])
    full_shape = list(shape)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    part_shape = list(shape)
    part_shape[row_axis] = len(rows)
    block = _dropout_keep(part_shape, 0.3, BlockMasks(g1, rows, shape[
        row_axis]), "cpu", row_axis)
    whole = _dropout_keep(full_shape, 0.3, g2, "cpu", row_axis)
    assert torch.equal(block, whole.index_select(row_axis, rows))
    assert torch.equal(g1.get_state(), g2.get_state())


def test_host_backup_is_bit_equal(runs):
    for r in runs[0]["rows_host_backup"]:
        dev, host = r[False], r[True]
        for a, b in zip(dev["per_batch"], host["per_batch"]):
            np.testing.assert_array_equal(a, b)
        for k in dev["mem"]:
            assert torch.equal(dev["mem"][k], host["mem"][k]), k
        assert torch.equal(dev["index"], host["index"])
