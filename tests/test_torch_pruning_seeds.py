"""The seed axis under the pruning strategy (``parallel_runs`` = S > 1 with
``tppr_strategy="pruning"``: zebra_tpu_torch/train/phase.py, loop.py),
at the sizes of test_torch_pruning_trainer.py (1,200 events, dims 16,
top-5, the MOOC run's (α, β), BFS width 5 and depth 2), S = 2.

- One BFS call over [src; dst; neg_0; neg_1], split into the lanes'
  [src, dst, neg_s] blocks, equals a call per lane bit for bit: the BFS
  answers each root on its own (test_torch_pruning.py).
- Lane s against the port's single-seed Trainer with seed s, dropout 0.1
  (the same masks), f32 tables: every phase metric of an epoch, validate
  and test, and the params, within 1e-5 (test_torch_seed_trainer.py's bar).
- Against JAX ``Trainer(parallel_runs=2)`` under pruning (its
  ``_run_phase_seeds`` with the BFS inside the vmapped lane step, as
  test_seed_parallel.py:468 runs it) from the same stacked params, dropout
  0, f32 tables, lr 1e-3: the per-seed metrics of an epoch and validate
  within 1e-6 (test_torch_seed_trainer.py's bar against JAX)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_pruning_trainer import F32, SMALL, _cols
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.index.streaming import TpprQueries
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.phase import (
    _lane_rows,
    ensemble_tensors,
    pruned_queries,
)

S = 2
FIELDS = ("loss", "ap", "auc", "acc")


def port(tmp_path, sub="ckpt", **kw):
    cols, ef = _cols()
    cfg = Config(**{**SMALL, "checkpoint_dir": str(tmp_path / sub), **kw})
    return Trainer(cfg, split_data(*cols), ef, device="cpu")


def test_one_bfs_call_gives_each_lane_its_own_queries(tmp_path):
    t = port(tmp_path, parallel_runs=3)
    cfg, b = t.cfg, 50
    s = t._streams["train"].stream
    negs = torch.from_numpy(t._draw_train_negs(0)[:, 300: 300 + b])
    src, dst, ts = s.src[300: 300 + b], s.dst[300: 300 + b], s.t[300: 300 + b]
    ab = ensemble_tensors(cfg, "cpu")
    q = pruned_queries(cfg, t.train_nbr_index, ab, [src, dst, *negs], ts)
    lanes = TpprQueries(*(x[:, _lane_rows(3, b, "cpu")].movedim(1, 0)
                          for x in q))
    assert (q.w > 0).float().mean() > 0.5
    for lane in range(3):
        alone = pruned_queries(cfg, t.train_nbr_index, ab,
                               [src, dst, negs[lane]], ts)
        for got, want in zip(lanes, alone):
            assert torch.equal(got[lane], want), lane


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(train=tr, val=val, nn_val=nn_val, test=test, nn_test=nn_test)


def test_lanes_equal_single_seed_trainers(tmp_path):
    par = port(tmp_path, parallel_runs=S, dropout=0.1,
               memory_dtype="float32", message_dtype="float32")
    rp = _run(par)
    assert par.index_state is None and par.index_waves == 0
    for lane in range(S):
        one = port(tmp_path, f"one{lane}", seed=lane, dropout=0.1,
                   memory_dtype="float32", message_dtype="float32")
        r1 = _run(one)
        for phase, r in r1.items():
            for f in FIELDS:
                assert abs(getattr(rp[phase], f)[lane]
                           - getattr(r, f)) <= 1e-5, (lane, phase, f)
        for key, v in one.params.state_dict().items():
            d = (par.params.state_dict()[key][lane] - v).abs().max()
            assert float(d) <= 1e-5, (lane, key)


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    cols, ef = _cols()
    jcfg = JaxConfig(**{**SMALL, "lr": 1e-3}, **F32, parallel_runs=S,
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    out = {}
    for name, t in (("jax", jt), ("port", pt)):
        tr = t.train_epoch()
        val, nn_val = t.validate()
        out[name] = dict(train=tr, val=val, nn_val=nn_val)
    return out


@pytest.mark.parametrize("phase", ["train", "val", "nn_val"])
def test_seed_metrics_match_jax(jax_pair, phase):
    for f in FIELDS:
        got = getattr(jax_pair["port"][phase], f)
        want = np.asarray(getattr(jax_pair["jax"][phase], f))
        assert got.shape == (S,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)
