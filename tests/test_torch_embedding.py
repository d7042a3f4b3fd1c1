"""The port's towers other than diffusion (zebra_tpu_torch/models/
embedding.py) against the JAX package's, at identical params, memory with
pending messages on about half the rows, and one adjacency index: dims 8
(time 16), edge dim 8, 64 rows, a 300-event graph, 30 roots, n_degree 3.

- ``recursive_embed`` (graph_attention and graph_sum, 1 and 2 hops),
  ``time_embed`` and ``identity_embed`` in train mode (lazy cell updates)
  and eval mode, f32 tables and (2 hops) bf16 tables: within 1e-6 of each result's
  largest entry where that exceeds 1 (the time tower scales rows by the
  unnormalized Δt), absolute below (measured on the CPU: 4.2e-7, the
  products' summation order; the eval rows of identity and time equal);
- the seed-lane form (stacked params, flat tables of two lanes, one lookup
  for both lanes' roots per hop) against a call per lane: within 1e-6
  (measured: 5.5e-8, a batched product against a plain one);
- an edge id past the feature table reads its last row, as JAX's clamped
  gather does."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_train import _memory
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.neighbor_finder import build_neighbor_index as jax_build
from zebra_tpu.models import embedding as jemb
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.models import embedding as pemb
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import lane_params, stack_params

Q = 30
BAR = 1e-6


def _setup(tower, n_layer=2, dtype="float32", extra_edge=False):
    jcfg = JaxConfig(node_dim=8, time_dim=16, memory_dim=8, n_degree=3,
                     n_layer=n_layer, n_head=2, embedding_module=tower,
                     n_nodes=64, n_edges=401, edge_dim=8, memory_dtype=dtype,
                     message_dtype=dtype)
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    data, ef = synthetic_stream(400, 30, 30, edge_dim=8, seed=0)
    cols = [np.asarray(c[:300]) for c in (data.sources, data.destinations,
                                          data.timestamps, data.edge_idxs)]
    if extra_edge:   # an observed event whose edge id lies past the table
        cols = [np.append(c, v) for c, v in zip(
            cols, (cols[0][-1], cols[1][-1], cols[2][-1] + 1.0, 10_000))]
    rs = np.random.RandomState(3)
    roots = np.concatenate([cols[0][-10:], cols[1][-10:],
                            rs.randint(1, 61, Q - 20)]).astype(np.int32)
    times = (cols[2][-1] + 1.0 + rs.rand(Q) * 5).astype(np.float32)
    jp = init_tgn_params(jax.random.key(0, impl="threefry2x32"), jcfg)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jmem, pmem = _memory(cfg, dtype)
    return dict(jcfg=jcfg, cfg=cfg, ef=ef, jp=jp, pp=pp, jmem=jmem,
                pmem=pmem, roots=roots, times=times,
                jidx=jax_build(*cols, cfg.n_nodes),
                pidx=build_neighbor_index(*cols, cfg.n_nodes, "cpu"))


def _jax(s, train):
    cfg, args = s["jcfg"], (jnp.asarray(s["roots"]), jnp.asarray(s["times"]))
    if cfg.embedding_module in ("graph_attention", "graph_sum"):
        return jemb.recursive_embed(cfg, s["jp"], s["jmem"],
                                    jnp.asarray(s["ef"]), s["jidx"], *args,
                                    train)
    if cfg.embedding_module == "time":
        return jemb.time_embed(cfg, s["jp"], s["jmem"], *args, train)
    return jemb.identity_embed(cfg, s["jp"], s["jmem"], args[0], train)


def _port(s, train, params=None, mem=None, roots=None, offs=None):
    return pemb.tower_embed(
        s["cfg"], s["pp"] if params is None else params,
        s["pmem"] if mem is None else mem, torch.from_numpy(s["ef"]),
        s["pidx"], torch.from_numpy(s["roots"]) if roots is None else roots,
        torch.from_numpy(s["times"]), train, offs)


CASES = [("graph_attention", 1, "float32"), ("graph_sum", 1, "float32")] + [
    (tower, 2, dtype) for tower in ("graph_attention", "graph_sum", "time",
                                    "identity")
    for dtype in ("float32", "bfloat16")]


def _close(got, want, bar):
    """Within ``bar`` of each tensor's largest entry where that exceeds 1
    (the time tower scales rows by the unnormalized Δt)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(bridge.to_numpy(got), want, rtol=0,
                               atol=bar * scale)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("tower,n_layer,dtype", CASES,
                         ids=[f"{t}-{n}-{d}" for t, n, d in CASES])
def test_tower_matches_jax(tower, n_layer, train, dtype):
    s = _setup(tower, n_layer, dtype)
    want = _jax(s, train)
    got = _port(s, train)
    assert got.shape == want.shape == (Q, 8)
    assert np.abs(np.asarray(want, np.float32)).max() > 0
    _close(got, want, BAR)


@pytest.mark.parametrize("tower", ["graph_attention", "graph_sum", "time",
                                   "identity"])
def test_seed_lanes_equal_per_lane_calls(tower):
    """Two lanes: lane 1's params from another init, its memory from
    another draw; per-lane roots in train mode, shared roots in eval."""
    s = _setup(tower)
    other = _setup(tower)
    other_p = init_tgn_params(jax.random.key(1, impl="threefry2x32"),
                              s["jcfg"])
    lanes = [s["pp"], bridge.params_from_numpy(
        jax.tree.map(np.asarray, other_p), "cpu")]
    params = stack_params(lanes)
    _, mem1 = _memory(s["cfg"], "float32", seed=5)
    flat = MemoryState(*(torch.cat([a, b]) for a, b in zip(s["pmem"], mem1)))
    offs = torch.tensor([0, s["cfg"].n_nodes])
    roots = torch.from_numpy(s["roots"])
    per_lane = torch.stack([roots, roots.flip(0)])
    got_train = _port(s, True, params, flat, per_lane, offs)
    got_eval = _port(s, False, params, flat, roots, offs)
    for lane, mem in enumerate((s["pmem"], mem1)):
        p = lane_params(params, lane)
        _close(got_train[lane], _port(other, True, p, mem, per_lane[lane]),
               1e-6)
        _close(got_eval[lane], _port(other, False, p, mem, roots), 1e-6)


@pytest.mark.parametrize("tower", ["graph_attention", "graph_sum"])
def test_edge_id_past_the_table_reads_the_last_row(tower):
    s = _setup(tower, extra_edge=True)
    assert int(s["pidx"].eidx.max()) >= s["ef"].shape[0]
    got = _port(s, False)
    _close(got, _jax(s, False), BAR)
    # and the clamp changes the answer: row 0 would give another one
    s["ef"] = np.concatenate([s["ef"][:-1], np.zeros_like(s["ef"][-1:])])
    assert float((_port(s, False) - got).abs().max()) > 1e-4
