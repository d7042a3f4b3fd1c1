"""The port's seed-parallel Trainer (``parallel_runs`` = S > 1, zebra_tpu_torch
/train/loop.py, phase.py and step.py) against the JAX package's and against
the port's own single-seed Trainer, at the sizes of test_torch_trainer.py
(1,200 events, 40 + 40 nodes, bs 50, index_chunk 200: four superchunks,
dims 16, top-5, the flagship (α, β) ensemble), S = 3.

Bars:
- against JAX ``Trainer(parallel_runs=3)`` from the same stacked params
  (bridge), dropout 0, f32 tables, lr 1e-3: the per-seed train negatives
  identical; every per-seed loss, AP, AUC and accuracy of one epoch,
  validate and test within 1e-6 (measured on the CPU: 1.2e-7). At lr 3e-3
  the third lane (seed 2) parts from JAX already in the first epoch, as a
  single-seed port Trainer with that init does: the documented Adam
  amplification of summation-order differences (ROADMAP.md §3), not a
  seed-axis effect, so this test trains at lr 1e-3;
- lane s against the port's single-seed Trainer with seed s, dropout 0.1
  (the same masks, drawn from each seed's generator), f32 tables: params
  and every phase metric within 1e-5 after an epoch (measured: 1e-6 and
  0); with ``parallel_lr`` each lane against a single run at its lr;
- one train batch at S = 4 enqueues at most 1.25× the aten operations of a
  single-seed batch (``TorchDispatchMode``), with the single-seed Adam on
  its foreach path as on the card.

The seed-parallel ``fit``, its resumes and state files:
test_torch_seed_fit.py."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.index.waves import wave_scan_chunk
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.graphs import Bound
from zebra_tpu_torch.train.phase import run_phase

S = 3
SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), lr=1e-3)
F32 = dict(memory_dtype="float32", message_dtype="float32")
PHASES = ("train", "val", "nn_val", "test", "nn_test")
FIELDS = ("loss", "ap", "auc", "acc")


def _cols():
    data, ef = synthetic_stream(n_events=1200, n_users=40, n_items=40,
                                edge_dim=4, seed=0)
    return (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels), ef


def port(tmp_path, sub="ckpt", **kw):
    cols, ef = _cols()
    cfg = Config(**{**SMALL, "checkpoint_dir": str(tmp_path / sub), **kw})
    return Trainer(cfg, split_data(*cols), ef, device="cpu")


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(zip(PHASES, (tr, val, nn_val, test, nn_test)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX Trainer, port Trainer, JAX results, port results, the train
    negatives of epoch 0 of both)."""
    cols, ef = _cols()
    jcfg = JaxConfig(**SMALL, **F32, dropout=0.0, parallel_runs=S,
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    negs = (jt._draw_train_negs(0), pt._draw_train_negs(0))
    return jt, pt, _run(jt), _run(pt), negs


def test_seed_negatives_and_stack_match_jax(pair):
    jt, pt, _, _, (jnegs, pnegs) = pair
    assert pnegs.shape == (S, len(pt._streams["train"].host["src"]))
    np.testing.assert_array_equal(pnegs, jnegs)
    np.testing.assert_array_equal(pt._neg_base, jt._neg_base)
    assert pt.mem.memory.shape[0] == S * pt.cfg.n_nodes


@pytest.mark.parametrize("phase", PHASES)
def test_seed_metrics_match_jax(pair, phase):
    _, _, jres, pres, _ = pair
    for f in FIELDS:
        got, want = getattr(pres[phase], f), np.asarray(getattr(jres[phase], f))
        assert got.shape == (S,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)


def test_seed_memory_after_test_matches_jax(pair):
    jt, pt, _, _, _ = pair
    got = bridge.memory_to_numpy(pt.mem, n_seeds=S)
    for f, g in zip(got._fields, got):
        w = np.asarray(getattr(jt.mem, f))
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f)


def _single(tmp_path, s, **kw):
    return port(tmp_path, f"one{s}", seed=s, **kw)


@pytest.mark.parametrize("lane", range(S))
def test_lane_equals_a_single_seed_trainer(tmp_path, lane):
    par = port(tmp_path, parallel_runs=S, dropout=0.1, **F32)
    one = _single(tmp_path, lane, dropout=0.1, **F32)
    rp, r1 = _run(par), _run(one)
    for phase in PHASES:
        for f in FIELDS:
            assert abs(getattr(rp[phase], f)[lane]
                       - getattr(r1[phase], f)) <= 1e-5, (phase, f)
    for key, v in one.params.state_dict().items():
        d = (par.params.state_dict()[key][lane] - v).abs().max()
        assert float(d) <= 1e-5, key


def test_parallel_lr_lanes_step_at_their_lr(tmp_path):
    lrs = (3e-3, 1e-3)
    par = port(tmp_path, parallel_runs=2, parallel_lr=lrs, dropout=0.0, **F32)
    rp = par.train_epoch()
    assert par.optimizer.lrs == lrs
    for lane, lr in enumerate(lrs):
        one = _single(tmp_path, lane, lr=lr, dropout=0.0, **F32)
        r1 = one.train_epoch()
        np.testing.assert_allclose(rp.per_batch[:, lane], r1.per_batch,
                                   rtol=0, atol=1e-5)
        for key, v in one.params.state_dict().items():
            d = (par.params.state_dict()[key][lane] - v).abs().max()
            assert float(d) <= 1e-5, (lr, key)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _batch_ops(tmp_path, n_seeds):
    """aten operations of one train batch of a warmed-up Trainer."""
    t = port(tmp_path, f"ops{n_seeds}", parallel_runs=n_seeds,
             index_chunk=50)
    if n_seeds == 1:   # the card's Adam: the foreach path
        t.optimizer = torch.optim.Adam(t.params.parameters(), lr=t.cfg.lr,
                                       foreach=True)
    t.train_epoch(max_chunks=4)
    negs = np.ascontiguousarray(t._draw_train_negs(0).T)
    stream = t._streams["train"].stream._replace(neg=torch.from_numpy(negs))
    cs = type(stream)(*(x[200:250] for x in stream))
    plan = t._wave_plans("train", negs, range(4, 5))[4]
    _, rows = wave_scan_chunk(t.index_state, t._tppr, *cs, plan)
    with _Count() as count:
        run_phase(Bound(t.cfg, t.params, t.mem, t.edge_feats, t._dropout,
                        t._offs), True, t.optimizer, cs, rows, [50])
    return sum(count.n.values())


def test_a_seed_parallel_batch_is_one_batched_pass(tmp_path):
    one, four = _batch_ops(tmp_path, 1), _batch_ops(tmp_path, 4)
    assert four <= 1.25 * one, (one, four)


def test_seed_parallel_phase_results_are_per_seed(tmp_path):
    t = port(tmp_path, parallel_runs=S)
    r = t.train_epoch()
    assert r.per_batch.shape[1:] == (S, 4) and r.ap.shape == (S,)
    assert t.index_waves == r.waves > 0
