"""Serving the recursive towers (zebra_tpu_torch/serve.py with
models/embedding.py) against the JAX package's LinkPredictor and
EnsemblePredictor built from the same params, memory and a 300-event
adjacency index with its base stream; dims 16, n_degree 3, n_layer 2, f32
tables.

- three ``observe`` batches of 40 (each folded into the adjacency index),
  then ``score``: memory within 1e-5, last_update exact, scores within
  1e-5 (test_torch_serve.py's f32 bars; measured on the CPU: memory
  within 1.8e-7, scores within 1.2e-7);
- an observed edge id past the feature table, then a score that reads it:
  the recursion reads the table's last row, as JAX's clamped gather does;
- ``EnsemblePredictor`` of two members against JAX's, the same bars;
- the CLI with ``--embedding_module graph_attention`` writes a state file
  that ``LinkPredictor.from_checkpoint(events=...)`` serves as
  ``from_trainer`` does (bit-equal), and that without ``events`` is
  refused in JAX's words."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_cli import _argv, _toy
from tests.test_torch_train import _memory
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.neighbor_finder import build_neighbor_index as jax_build
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu.serve import EnsemblePredictor as JaxEnsemblePredictor
from zebra_tpu.serve import LinkPredictor as JaxLinkPredictor
from zebra_tpu_torch import bridge, cli
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import get_data
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor

B, S = 40, 2


def _pair(tower, n_models=1):
    """(stream columns, JAX predictor, port predictor) over params from JAX
    keys 0.., memory with pending messages and the first 300 events' graph.
    ``n_models`` > 1: ensembles of that many members."""
    data, ef = synthetic_stream(460, 30, 30, edge_dim=8, seed=0)
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs)
    jcfg = JaxConfig(node_dim=16, time_dim=16, memory_dim=16, n_degree=3,
                     n_layer=2, embedding_module=tower, n_nodes=64,
                     n_edges=461, edge_dim=8, memory_dtype="float32",
                     message_dtype="float32")
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    graph = [c[:300] for c in cols]
    keys = [jax.random.key(s, impl="threefry2x32") for s in range(n_models)]
    mems = [_memory(cfg, "float32", seed=2 + s) for s in range(n_models)]
    if n_models == 1:
        jp, (jmem, pmem) = init_tgn_params(keys[0], jcfg), mems[0]
        jcls, pcls = JaxLinkPredictor, LinkPredictor
    else:
        jp = jax.tree.map(lambda *x: jnp.stack(x),
                          *(init_tgn_params(k, jcfg) for k in keys))
        jmem = jax.tree.map(lambda *x: jnp.stack(x), *(j for j, _ in mems))
        pmem = type(mems[0][1])(*(torch.stack(x) for x in zip(
            *(p for _, p in mems))))
        jcls, pcls = JaxEnsemblePredictor, EnsemblePredictor
    ref = jcls(jcfg, jp, jmem, (), jnp.asarray(ef),
               jax_build(*graph, jcfg.n_nodes), events=graph)
    port = pcls(cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"),
                pmem, None, ef,
                build_neighbor_index(*graph, cfg.n_nodes, "cpu"), graph,
                device="cpu")
    return cols, ref, port


def _observe_then_score(cols, ref, port):
    for lo in range(300, 300 + 3 * B, B):
        batch = [c[lo: lo + B] for c in cols]
        ref.observe(*batch)
        port.observe(*batch)
    q = slice(300 + 3 * B, 300 + 4 * B)
    got = port.score(cols[0][q], cols[1][q], cols[2][q])
    want = np.asarray(ref.score(cols[0][q], cols[1][q], cols[2][q]))
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    mem = ref.mem.memory
    np.testing.assert_allclose(
        port.mem.memory.numpy(),
        np.asarray(mem).reshape(port.mem.memory.shape), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        port.mem.last_update.numpy(),
        np.asarray(ref.mem.last_update).reshape(-1))
    # every observed event is in the adjacency index
    assert port.nbr_index.ts.shape[0] == 2 * (300 + 3 * B)


@pytest.mark.parametrize("tower", ["graph_attention", "graph_sum"])
def test_observe_then_score_matches_jax(tower):
    _observe_then_score(*_pair(tower))


def test_ensemble_matches_jax():
    cols, ref, port = _pair("graph_attention", n_models=S)
    assert port.n_models == ref.n_models == S
    _observe_then_score(cols, ref, port)
    q = slice(300, 300 + B)
    got = port.member_scores(cols[0][q], cols[1][q], cols[2][q])
    want = np.asarray(ref.member_scores(cols[0][q], cols[1][q], cols[2][q]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tower", ["graph_attention", "graph_sum"])
def test_edge_id_past_the_table_is_clamped_as_jax_clamps(tower):
    cols, ref, port = _pair(tower)
    src, dst, t = int(cols[0][299]), int(cols[1][299]), float(cols[2][299])
    fresh = [[src], [dst], [t + 1.0], [10_000]]      # the table has 461 rows
    ref.observe(*fresh)
    port.observe(*fresh)
    assert int(port.nbr_index.eidx.max()) == 10_000
    call = ([src, dst], [dst, src], [t + 2.0, t + 2.0])
    got, want = port.score(*call), np.asarray(ref.score(*call))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the last row is read: zeroing it moves the scores
    port.edge_feats[-1] = 0.0
    assert np.abs(port.score(*call) - got).max() > 1e-6


def test_cli_state_file_serves_with_events_only(tmp_path):
    _toy(tmp_path)
    (trainer, results), = cli.main(_argv(
        tmp_path, "toy", "--n_epoch", "1", "--state_every", "1",
        "--embedding_module", "graph_attention", "--n_degree", "3",
        "--n_layer", "2"))
    assert np.isfinite(results["test_ap"]) and trainer.index_state is None
    assert "_bs_50_layer_2_" in trainer.cfg.run_name()
    state = tmp_path / "ckpt" / (trainer.cfg.run_name() + ".state.ckpt")
    fu = get_data("toy", str(tmp_path)).full
    events = (fu.sources, fu.destinations, fu.timestamps, fu.edge_idxs)
    ef = trainer.edge_feats.numpy()
    with pytest.raises(ValueError, match="query an adjacency index"):
        LinkPredictor.from_checkpoint(str(state), edge_feats=ef,
                                      device="cpu")
    served = LinkPredictor.from_checkpoint(str(state), edge_feats=ef,
                                           events=events, device="cpu")
    assert served.index_state is None
    live = LinkPredictor.from_trainer(trainer)
    # the Trainer has run test() since the file was written: serve the
    # file's memory from both
    live.mem = type(live.mem)(*(x.clone() for x in served.mem))
    call = (fu.sources[-B:], fu.destinations[-B:], fu.timestamps[-B:] + 1.0)
    np.testing.assert_array_equal(served.score(*call), live.score(*call))
