"""The seed axis with the graph_attention tower (``parallel_runs`` = 2:
zebra_tpu_torch/train/phase.py, loop.py with models/embedding.py), at the
sizes of test_torch_towers_trainer.py but 600 events.

- Lane s against the port's single-seed Trainer with seed s: every phase
  metric of an epoch, ``validate()`` and ``test()``, and the params, within
  1e-5 (test_torch_pruning_seeds.py's bar; the lanes' memory rows sit at
  their offsets, while one adjacency lookup per hop serves all lanes' raw
  node ids). The key projection is held within 2·lr per step, as
  test_torch_towers_trainer.py says why.
- Against JAX ``Trainer(parallel_runs=2)`` (its ``_run_phase_seeds`` with
  the recursion inside the vmapped lane step) from the same stacked params:
  the per-seed metrics of an epoch and ``validate()`` within 1e-6
  (test_torch_seed_trainer.py's bar against JAX).
- The pruning strategy changes nothing for a tower: no BFS, the same
  epoch, bit for bit."""

import dataclasses

import numpy as np
import pytest

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_towers_trainer import F32, SMALL, _cols
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.train.loop import Trainer

S = 2
TOWER = "graph_attention"
FIELDS = ("loss", "ap", "auc", "acc")
N_EVENTS = 600


def port(tmp_path, sub="ckpt", **kw):
    cols, ef = _cols(N_EVENTS)
    cfg = Config(**{**SMALL, "embedding_module": TOWER,
                    "checkpoint_dir": str(tmp_path / sub), **kw})
    return Trainer(cfg, split_data(*cols), ef, device="cpu")


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(train=tr, val=val, nn_val=nn_val, test=test, nn_test=nn_test)


def test_lanes_equal_single_seed_trainers(tmp_path):
    par = port(tmp_path, parallel_runs=S, **F32)
    rp = _run(par)
    assert par.index_state is None and par.index_waves == 0
    steps = rp["train"].per_batch.shape[0]
    for lane in range(S):
        one = port(tmp_path, f"one{lane}", seed=lane, **F32)
        r1 = _run(one)
        for phase, r in r1.items():
            for f in FIELDS:
                assert abs(getattr(rp[phase], f)[lane]
                           - getattr(r, f)) <= 1e-5, (lane, phase, f)
        for key, v in one.params.state_dict().items():
            d = float((par.params.state_dict()[key][lane] - v).abs().max())
            bar = (2 * par.cfg.lr * steps if key.endswith(("w_k", "b_k"))
                   else 1e-5)
            assert d <= bar, (lane, key, d)


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    cols, ef = _cols(N_EVENTS)
    jcfg = JaxConfig(**SMALL, **F32, embedding_module=TOWER, parallel_runs=S,
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


def test_pruning_strategy_changes_nothing(tmp_path):
    """Under ``tppr_strategy="pruning"`` the tower runs as under streaming:
    no index state, no BFS, the same adjacency indices, the same epoch."""
    out = []
    for strategy in ("streaming", "pruning"):
        t = port(tmp_path, strategy, tppr_strategy=strategy)
        r = t.train_epoch()
        assert t.index_state is None and r.index_seconds == 0
        out.append(r.per_batch)
    np.testing.assert_array_equal(*out)
