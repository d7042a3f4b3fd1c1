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
    OPTION_LR,
    PHASES,
    ROW_OPTIONS,
    SMALL,
    option_trainer,
    recorded_scores,
    run_group,
    run_rows,
    splits,
    trainer,
)
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream as jax_stream
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.models.tgn import BlockMasks, _dropout_keep
from zebra_tpu_torch.serve import LinkPredictor

FIELDS = ("loss", "ap", "auc", "acc")
PORT_ATOL, JAX_EVAL_ATOL, JAX_TRAIN_ATOL = 1e-6, 1e-6, 1e-5
JAX_MEMORY_ATOL = 1e-4


def _jax_phases(jt) -> dict:
    """A JAX Trainer's train epoch, validate() and test(): the phase
    results and the memory after training and at the end."""
    tr = jt.train_epoch()
    train_mem = jax.tree.map(np.asarray, jt.mem)
    phases = (tr, *jt.validate(), *jt.test())
    return dict(phases=dict(zip(PHASES, phases)), train_mem=train_mem,
                mem=jax.tree.map(np.asarray, jt.mem))


def option_runs(tmp, names, extra=()) -> dict:
    """Each option of ``names`` (``ROW_OPTIONS``) at this module's sizes
    (f32 tables, dropout 0): JAX's ``Trainer(n_devices=2)``, whose params
    the ranks and one process start from, through a train epoch,
    validate() and test(); the ranks (one spawned group,
    ``sc_rows_<name>``); the one-process port (``run_rows``); and, but for
    the interleaved option, one process's validate() and test() from the
    ranks' train-end state file (``same_state``). The scenarios ``extra``
    run in the same group; their ranks' results are under ``"extra"``."""
    data, ef = jax_stream(n_events=1200, n_users=40, n_items=40, edge_dim=4,
                          seed=0)
    jsplits = jax_split_data(data.sources, data.destinations,
                             data.timestamps, data.edge_idxs, data.labels)
    jts = {}
    for name in names:
        jcfg = JaxConfig(**{**SMALL, **F32, "lr": OPTION_LR,
                            **ROW_OPTIONS[name]},
                         dropout=0.0, n_devices=2,
                         checkpoint_dir=str(tmp / f"jax_{name}"))
        jts[name] = JaxTrainer(jcfg, jsplits, ef)
        with open(tmp / f"{name}_params.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, jts[name].params), f)
    # the ranks run while this process runs JAX and the one-process port
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(run_group, [f"rows_{n}" for n in names]
                            + list(extra), tmp)
        one = {n: run_rows(option_trainer(str(tmp), n, 1),
                           str(tmp / f"{n}_one.state.ckpt")) for n in names}
        jres = {n: _jax_phases(jt) for n, jt in jts.items()}
        ranks = group.result()
    out = {"extra": {e: ranks[e] for e in extra}}
    for n in names:
        rs = ranks[f"rows_{n}"]
        out[n] = dict(name=n, ranks=rs, one=one[n], jax=jres[n],
                      same_state=None)
        if rs[0]["state"] is None or n.endswith("_il"):
            continue
        t = option_trainer(str(tmp), n, 1)
        t.restore_state(rs[0]["state"])
        scores = []
        with recorded_scores(scores):
            phases = (*t.validate(), *t.test())
        out[n]["same_state"] = dict(
            per_batch=dict(zip(PHASES[1:], (p.per_batch for p in phases))),
            mem={k: v.clone() for k, v in t.mem._asdict().items()},
            scores=torch.stack(scores))
    return out


# ------------------------------------------------------------ options
#
# The test_torch_row_sharded_*.py files hold the options beyond the
# flagship's (tests/torch_rank_worker.py's ROW_OPTIONS) with option_runs
# and these bars (option_tests):
# - every batch's (pos, neg) probabilities of every phase within 1e-6 of
#   the one-process port from the same params (2.4e-7 measured), and every
#   eval phase's within 1e-6 of one process's run from the ranks'
#   train-end state file (1.2e-7);
# - every phase's per-batch loss within 1e-6 of the one-process port's,
#   also of its size (the time tower's losses reach 5, where 1e-6 is two
#   f32 ulps); AP, AUC and accuracy within 1e-6 at the first train batch
#   (the same params) and within one event's share of the batch,
#   1/(its valid events), elsewhere (the replacement bar below);
# - the memory tables after the train epoch and at the end within 1e-6 of
#   the one-process port and 1e-4 of JAX's n_devices=2 Trainer, bit-equal
#   on both ranks; the params bit-equal across the ranks;
# - JAX's phase means within 1e-6 (eval) and 1e-5 (the train epoch; the
#   loss also within 1e-5 of its size), AP, AUC and accuracy widened by
#   one event's share of each batch where the ranks and the one-process
#   port break a tie apart;
# - the ranks' train-end state file served by from_checkpoint(...,
#   events=...) on one device within 1e-5 of the one-process file
#   (test_torch_towers_serve.py's bar).
# Why one event's share replaces 1e-6 for AP, AUC and accuracy: the
# gradient's sum over two blocks rounds in another order than one
# process's backward, and a block's products round apart from the whole
# batch's, so probabilities differ by ulps (the bar above holds them);
# the f32 probabilities of these runs hold 15-77 exact positive-negative
# ties per epoch (counted in one process), and a tie that one run keeps
# and the other breaks by an ulp moves its batch's accuracy by one event
# (1/31 in a 31-event batch, measured under mean from the same state) and
# AUC and AP by that event's pairs (2e-4 to 1.2e-3 measured). The option
# runs train at JAX's default lr, 1e-4, as the towers' own tests do
# (test_torch_towers_trainer.py): at lr 1e-3 the one-process port itself
# moves 1.2e-2 from JAX in the memory under the mlp message function with
# both message-source flags, with no rank involved (Adam's normalized
# steps turn near-zero gradients' last bits into lr-sized steps).
OPTION_LOSS_RTOL = 1e-6
SPLIT_OF = dict(train="train", val="val", nn_val="new_node_val",
                test="test", nn_test="new_node_test")


def tie_atol(phase: str) -> np.ndarray:
    """One event's share of each real batch of ``phase``, [n_batches, 1]."""
    n = getattr(splits()[0], SPLIT_OF[phase]).n_interactions
    b = SMALL["bs"]
    return 1.0 / np.minimum(b, n - b * np.arange(-(-n // b)))[:, None]


def _scores_close(got, want) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=PORT_ATOL)


def check_one_process(o: dict, phase: str) -> None:
    """Every rank's run against the one-process port's from the same
    params: the probabilities of every phase (checked with the train
    phase) and the per-batch metrics of ``phase`` (module section)."""
    want = o["one"]["per_batch"][phase]
    tie = tie_atol(phase)
    for r in o["ranks"]:
        if phase == "train":
            _scores_close(r["scores"], o["one"]["scores"])
        got = r["per_batch"][phase]
        assert got.shape == want.shape == (len(tie), 4)
        np.testing.assert_allclose(got[:, 0], want[:, 0],
                                   rtol=OPTION_LOSS_RTOL, atol=PORT_ATOL)
        first = 1 if phase == "train" else 0
        np.testing.assert_allclose(got[:first, 1:], want[:first, 1:],
                                   rtol=0, atol=PORT_ATOL)
        assert (np.abs(got[first:, 1:] - want[first:, 1:])
                <= tie[first:] + PORT_ATOL).all(), (got, want)


def check_same_state(o: dict, phase: str) -> None:
    """An eval phase of the ranks against one process's from the ranks'
    train-end state file: the eval probabilities (checked with val) and
    the per-batch metrics (module section)."""
    same = o["same_state"]
    want = same["per_batch"][phase]
    tie = tie_atol(phase)
    for r in o["ranks"]:
        if phase == "val":
            n = same["scores"].shape[0]
            _scores_close(r["scores"][-n:], same["scores"])
        got = r["per_batch"][phase]
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0,
                                   atol=PORT_ATOL)
        assert (np.abs(got[:, 1:] - want[:, 1:]) <= tie + PORT_ATOL).all(), (
            got, want)


def check_jax(o: dict, phase: str, ties: bool = True) -> None:
    """Rank 0's phase means against JAX's n_devices=2 Trainer (module
    section); ``ties`` False holds AP, AUC and accuracy at the bar alone
    (a run whose one-process reference is another id space)."""
    per_batch = o["ranks"][0]["per_batch"][phase]
    apart = np.abs(per_batch - o["one"]["per_batch"][phase]) > PORT_ATOL
    widen = (ties * apart * tie_atol(phase)).mean(axis=0)
    atol = JAX_TRAIN_ATOL if phase == "train" else JAX_EVAL_ATOL
    for i, f in enumerate(FIELDS):
        got = float(per_batch[:, i].mean())
        want = float(getattr(o["jax"]["phases"][phase], f))
        bar = atol + (atol * abs(want) if f == "loss" else widen[i])
        assert abs(got - want) <= bar, (f, got, want, bar)


def check_memory(o: dict, when: str, against: str) -> None:
    """The gathered tables after training (``train_mem``) or at the end
    (``mem``) within 1e-6 of the one-process port's, 1e-4 of JAX's, and
    bit-equal on both ranks."""
    ranks = o["ranks"]
    got = {k: bridge.to_numpy(v) for k, v in ranks[0][when].items()}
    for k, v in ranks[1][when].items():
        assert torch.equal(v, ranks[0][when][k]), k
    if against == "one_process":
        want = {k: bridge.to_numpy(v) for k, v in o["one"][when].items()}
        atol = PORT_ATOL
    else:
        want = {f: np.asarray(getattr(o["jax"][when], f), np.float32)
                for f in o["jax"][when]._fields}
        atol = JAX_MEMORY_ATOL
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        np.testing.assert_allclose(v, want[k], rtol=0, atol=atol, err_msg=k)


def check_params_across_ranks(o: dict) -> None:
    r0, r1 = o["ranks"]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k


def served_scores(path: str, events=True) -> np.ndarray:
    """A state file served on one device (``from_checkpoint``, the full
    split's events): scores of 64 test queries, then again after observing
    16 test events."""
    sp, ef = splits()
    full, te = sp.full, sp.test
    pred = LinkPredictor.from_checkpoint(
        path, edge_feats=ef, device="cpu",
        events=(full.sources, full.destinations, full.timestamps,
                full.edge_idxs) if events else None)
    q = (te.sources[:64], te.destinations[:64], te.timestamps[:64])
    first = pred.score(*q)
    pred.observe(te.sources[-16:], te.destinations[-16:],
                 te.timestamps[-16:], te.edge_idxs[-16:])
    return np.stack([first, pred.score(*q)])


def check_served(o: dict, tmp, atol: float = 1e-5) -> None:
    """The ranks' train-end state file served on one device scores as the
    one-process file does, within the serve bar of
    test_torch_towers_serve.py."""
    got = served_scores(o["ranks"][0]["state"])
    want = served_scores(str(tmp / f"{o['name']}_one.state.ckpt"))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def option_tests(names, same_state: bool = True) -> dict:
    """The test functions of the option bars for the options ``names``,
    for a module to take into its namespace; they read its fixtures
    ``runs`` (``option_runs``) and ``tmp`` (the directory it ran in).
    ``same_state`` False leaves out the run from the same state (an
    interleaved run, whose state file a one-process Trainer refuses)."""
    over = pytest.mark.parametrize("name", names)
    phases = pytest.mark.parametrize("phase", PHASES)

    @over
    @phases
    def test_metrics_match_one_process(runs, name, phase):
        check_one_process(runs[name], phase)

    @over
    @pytest.mark.parametrize("phase", PHASES[1:])
    def test_eval_matches_one_process_from_the_same_state(runs, name,
                                                          phase):
        check_same_state(runs[name], phase)

    @over
    @phases
    def test_metrics_match_jax_row_sharded(runs, name, phase):
        check_jax(runs[name], phase)

    @over
    @pytest.mark.parametrize("when", ["train_mem", "mem"])
    @pytest.mark.parametrize("against", ["one_process", "jax"])
    def test_memory_matches(runs, name, when, against):
        check_memory(runs[name], when, against)

    @over
    def test_params_bit_equal_across_ranks(runs, name):
        check_params_across_ranks(runs[name])

    @over
    def test_state_file_serves_as_one_process(runs, tmp, name):
        check_served(runs[name], tmp)

    out = {f.__name__: f for f in (
        test_metrics_match_one_process, test_metrics_match_jax_row_sharded,
        test_memory_matches, test_params_bit_equal_across_ranks,
        test_state_file_serves_as_one_process)}
    if same_state:
        out[test_eval_matches_one_process_from_the_same_state.__name__] = (
            test_eval_matches_one_process_from_the_same_state)
    return out


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
