"""The port's train step and node-classification replay under the pruning
strategy (zebra_tpu_torch/train/phase.py, node_classification.py with
index/pruning.py) against the JAX package's, from the same params and
memory, f32 tables, dropout 0; the (α, β) of the MOOC pruning run, (0.1,
0.1) and (0.5, 0.95), BFS width 5 and depth 2.

Bars:
- one train step (``run_phase`` over one batch with a padded tail, the BFS
  inside): loss and metrics within 6e-7, as test_torch_train.py measures
  for the streaming step; the params after Adam within 6e-7 of each
  tensor's largest entry but for at most one entry in a thousand, and all
  within test_torch_train.py's f32 bar, 1e-5 (measured on the CPU: one
  GRU weight of 2,688 off by 2.5e-6, whose gradient is near zero, where
  Adam's step g/(|g|+ε) turns the gradient's summation order into a
  visible difference); the memory after the step's protocol, which runs
  the GRU with those params, within the replay bar below, 1e-5;
- the node-classification replay over the train stream (train graph) and
  the val stream (full graph): source embeddings and memory within 1e-5,
  as test_torch_node_classification.py holds the streaming replay."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_pruning_trainer import F32, PRUNING, SMALL, _cols
from tests.test_torch_train import _memory, _params
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.neighbor_finder import build_neighbor_index as jax_build
from zebra_tpu.train import node_classification as jnc
from zebra_tpu.train import phase as jphase
from zebra_tpu.train import step as jstep
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu.train.loop import _fresh_epoch_state
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.train import phase, step
from zebra_tpu_torch.train.graphs import Bound
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.node_classification import collect_source_embeddings

B = 40


def _close(got, want, bar, scale=False):
    got, want = bridge.to_numpy(got), np.asarray(want, np.float32)
    tol = bar * max(1.0, float(np.abs(want).max())) if scale else bar
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_one_train_step_matches_jax():
    """One batch of 40 events (the last 9 padding) through JAX's
    ``run_phase`` with the pruning BFS inside and the port's with the
    adjacency index, from the same params and memory."""
    jcfg = JaxConfig(node_dim=16, time_dim=16, memory_dim=16, topk=5, bs=B,
                     lr=3e-3, dropout=0.0, n_nodes=64, n_edges=401,
                     edge_dim=8, memory_dtype="float32",
                     message_dtype="float32", **PRUNING)
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
    jp, pp = _params(jcfg)
    opt = jstep.make_optimizer(jcfg)
    j_p, _, j_mem, _, j_ms = jphase.run_phase(
        jcfg, True, 1, jp, opt.init(jp), jmem, (), jax.random.PRNGKey(0),
        jnp.asarray(ef), jax_build(*graph, jcfg.n_nodes),
        jphase.Stream(**{k: jnp.asarray(v) for k, v in batch.items()}))
    ms = phase.run_phase(
        Bound(cfg, pp, pmem, torch.from_numpy(ef), None, None), True,
        step.make_optimizer(cfg, pp),
        phase.Stream(**{k: torch.from_numpy(v) for k, v in batch.items()}),
        build_neighbor_index(*graph, cfg.n_nodes, "cpu"), [B - 9]).metrics
    for i, name in enumerate(phase.METRICS):
        _close(ms[:, i], getattr(j_ms, name), 6e-7)
    for name, layer in pp.items():
        for key, p in layer.items():
            want = np.asarray(j_p[name][key], np.float32)
            diff = np.abs(bridge.to_numpy(p) - want)
            scale = max(1.0, float(np.abs(want).max()))
            assert (diff > 6e-7 * scale).mean() <= 1e-3, (name, key)
            _close(p, want, 1e-5, scale=True)
    _close(pmem.memory, j_mem.memory, 1e-5)


def test_node_replay_matches_jax(tmp_path):
    """collect_source_embeddings over the train stream (train graph) and
    the val stream (full graph) from a fresh state with the JAX init
    params."""
    cols, ef = _cols(800)
    jcfg = JaxConfig(**SMALL, **F32, checkpoint_dir=str(tmp_path))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    jmem, _ = _fresh_epoch_state(jt.cfg)
    jmem = jax.tree.map(jnp.asarray, jmem)
    pmem, pidx = pt._fresh_state()
    assert pidx is None
    for name, graph in (("train", "train_nbr_index"),
                        ("val", "full_nbr_index")):
        js = jt._streams[name]
        jmem, _, je = jnc.collect_source_embeddings(
            jt.cfg, js.n_batches, jt.params, jmem, (), jt.edge_feats,
            getattr(jt, graph), js.stream)
        valid = np.asarray(jt._host_streams[name]["valid"])
        want = np.asarray(je).reshape(-1, jt.cfg.hidden_dim)[valid]
        pmem, pidx, pe, waves = collect_source_embeddings(
            pt.cfg, pt.params, pmem, pidx, pt.edge_feats, pt._streams[name],
            getattr(pt, graph))
        assert waves == 0 and pidx is None
        got = pe.numpy()[pt._streams[name].host["valid"]]
        assert got.shape == want.shape and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pmem.memory.numpy(), np.asarray(jmem.memory),
                               rtol=0, atol=1e-5)
