"""The port's Trainer with the graph_attention tower (zebra_tpu_torch/train/
loop.py, phase.py, step.py with models/embedding.py) against the JAX
package's: 1,200 events on 40 + 40 nodes, bs 50, index_chunk 200, dims 16,
n_degree 4, n_layer 2, 2 heads, lr 1e-4 (the JAX default), f32 tables,
dropout 0. The helpers serve the other towers' files
(test_torch_towers_sum.py, test_torch_towers_memory_only.py) at the same
sizes.

Bars:
- one train step (``run_phase`` over one batch with a padded tail): loss
  and metrics within 6e-7, test_torch_pruning_step.py's bar; the params
  after Adam within 1e-5 of each tensor's largest entry, with at most one
  entry in a thousand past 6e-7 (Adam's g/(|g|+ε) turns a near-zero
  gradient's summation order into a visible step); the memory after the
  protocol within 1e-5;
- one epoch, ``validate()`` and ``test()``: every phase's loss, AP, AUC and
  accuracy within 1e-4, and the params within 1e-4 of each tensor's
  largest entry: test_torch_pruning_trainer.py's bars (measured on the CPU:
  metrics within 1.6e-5, params within 3e-7 of the largest entry, for each
  tower). At lr 3e-3 the graph_sum and identity params drift to 2.5e-4 and
  5e-3 of the largest entry in one epoch, while the metrics agree: early
  in the epoch the updater's gradients are near zero (fresh memory), and
  Adam's normalized steps turn their summation order into lr-sized
  differences that compound;
- but the attention layers' key projection ``w_k``, ``b_k``: a constant
  added to every logit of a row leaves the softmax as it is, so the
  gradient along a key column that is the same in every slot of a row (the
  bias; the slow time-encoding frequencies, whose cos(Δt·ω) stays near 1)
  is zero in exact arithmetic and rounding noise in both packages, and
  Adam steps such a weight by up to about lr either way. Measured after one
  step at lr 3e-3: the rows fed by the slow frequencies differ by up to
  2.2e-4, the others by 3e-8 to 6e-6. The two are held within 2·lr per
  step.

Port only: these towers keep no T-PPR index under either strategy, run no
wave and launch no santa kernel."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_train import _memory
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.neighbor_finder import build_neighbor_index as jax_build
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu.train import phase as jphase
from zebra_tpu.train import step as jstep
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.index import merge, scan
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.train import phase, step
from zebra_tpu_torch.train.graphs import Bound
from zebra_tpu_torch.train.loop import Trainer

TOWER = "graph_attention"
SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             n_degree=4, n_layer=2, n_head=2, lr=1e-4)
F32 = dict(dropout=0.0, memory_dtype="float32", message_dtype="float32")
PHASES = ("train", "val", "nn_val", "test", "nn_test")
B = 40


def _cols(n_events=1200, **kw):
    data, ef = synthetic_stream(n_events=n_events, n_users=40, n_items=40,
                                edge_dim=4, seed=0, **kw)
    return (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels), ef


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(zip(PHASES, (tr, val, nn_val, test, nn_test)))


def _pair(tmp_path_factory, tower, **kw):
    """A JAX and a port Trainer of ``tower`` from the JAX init params, and
    their epoch, validate and test results."""
    cols, ef = _cols()
    jcfg = JaxConfig(**{**SMALL, **kw}, **F32, embedding_module=tower,
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    merge.SANTA_MERGE.launches = scan.SANTA_SCAN.launches = 0
    return jt, pt, _run(jt), _run(pt)


def _check_phase(pair, phase_name):
    _, _, jres, pres = pair
    for f in ("loss", "ap", "auc", "acc"):
        got, want = getattr(pres[phase_name], f), getattr(jres[phase_name], f)
        assert abs(got - want) <= 1e-4, (f, got, want)


def _leaves(want_tree, got_tree):
    """(path, got, want) of every leaf of JAX's layout."""
    for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
        got = got_tree
        for key in path:
            got = got[getattr(key, "key", getattr(key, "idx", None))]
        assert got.shape == want.shape, path
        yield path, got, want


def _noise_only(path) -> bool:
    """The attention key projection, whose gradient is largely rounding
    noise."""
    return getattr(path[-1], "key", None) in ("w_k", "b_k")


def _check_params(pair):
    jt, pt, _, pres = pair
    steps = pres["train"].per_batch.shape[0]
    for path, got, want in _leaves(jax.tree.map(np.asarray, jt.params),
                                   bridge.params_to_numpy(pt.params)):
        diff = np.abs(got - want).max()
        if _noise_only(path):
            assert diff <= 2 * pt.cfg.lr * steps, path
        else:
            assert diff <= 1e-4 * max(np.abs(want).max(), 1e-30), path


def _check_no_index(pair):
    _, pt, _, pres = pair
    assert pt.index_state is None and pt.index_waves == 0
    assert all(r.waves == 0 and r.index_seconds == 0 for r in pres.values())
    assert merge.SANTA_MERGE.launches == scan.SANTA_SCAN.launches == 0
    assert pt.cfg.hidden_dim == pt.cfg.node_dim
    assert pt.params["affinity_fc1"]["w"].shape == (2 * 16, 16)


def _one_step(tower, **kw):
    """One batch of 40 events (the last 9 padding) through JAX's
    ``run_phase`` and the port's, from the same params and memory (pending
    messages on half the rows), over one 300-event adjacency index."""
    jcfg = JaxConfig(**{**SMALL, "bs": B, **kw}, **F32, n_nodes=64,
                     n_edges=401, edge_dim=8, embedding_module=tower)
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    data, ef = synthetic_stream(400, 30, 30, edge_dim=8, seed=0)
    cols = (data.sources, data.destinations, data.timestamps, data.edge_idxs)
    graph = [c[:300] for c in cols]
    e = slice(300, 300 + B)
    valid = np.ones(B, bool)
    valid[-9:] = False
    batch = dict(src=data.sources[e], dst=data.destinations[e],
                 neg=np.random.RandomState(1).randint(1, 61, B).astype(
                     np.int32),
                 t=data.timestamps[e].astype(np.float32),
                 eidx=data.edge_idxs[e], valid=valid)
    jmem, pmem = _memory(cfg, "float32")
    jp = init_tgn_params(jax.random.key(0, impl="threefry2x32"), jcfg)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pp.requires_grad_(True)
    opt = jstep.make_optimizer(jcfg)
    j_p, _, j_mem, _, j_ms = jphase.run_phase(
        jcfg, True, 1, jp, opt.init(jp), jmem, (), jax.random.PRNGKey(0),
        jnp.asarray(ef), jax_build(*graph, jcfg.n_nodes),
        jphase.Stream(**{k: jnp.asarray(v) for k, v in batch.items()}))
    ms = phase.run_phase(
        Bound(cfg, pp, pmem, torch.from_numpy(ef), None, None), True,
        step.make_optimizer(cfg, pp),
        phase.Stream(**{k: torch.from_numpy(v) for k, v in batch.items()}),
        None, [B - 9],
        nbr_index=build_neighbor_index(*graph, cfg.n_nodes, "cpu")).metrics
    for i, name in enumerate(phase.METRICS):
        np.testing.assert_allclose(ms[:, i].numpy(),
                                   np.asarray(getattr(j_ms, name)), rtol=0,
                                   atol=6e-7, err_msg=name)
    for path, got, want in _leaves(jax.tree.map(np.asarray, j_p),
                                   bridge.params_to_numpy(pp)):
        diff = np.abs(got - want)
        scale = max(1.0, float(np.abs(want).max()))
        if _noise_only(path):
            assert diff.max() <= 2 * cfg.lr, path
            continue
        assert (diff > 6e-7 * scale).mean() <= 1e-3, path
        assert diff.max() <= 1e-5 * scale, path
    np.testing.assert_allclose(pmem.memory.numpy(), np.asarray(j_mem.memory),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory, TOWER)


@pytest.mark.parametrize("phase_name", PHASES)
def test_phase_metrics_match_jax(pair, phase_name):
    _check_phase(pair, phase_name)


def test_params_after_epoch_match_jax(pair):
    _check_params(pair)


def test_no_index_no_wave_no_kernel(pair):
    _check_no_index(pair)


def test_one_train_step_matches_jax():
    _one_step(TOWER)
