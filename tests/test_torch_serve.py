"""The port's LinkPredictor (zebra_tpu_torch/serve.py) against the JAX
LinkPredictor built from the same parameters, memory and index: three
``observe`` batches, then ``score``.

Tolerances:
- index: the merge bar of test_torch_merge.py (XLA's fused scan may
  contract an FMA, so a weight can move by an ulp and two near-equal
  entries swap slots);
- f32 tables: memory within 1e-5, scores within 1e-5 (matrix-product
  summation order);
- bf16 tables: memory within 1e-2 (one bf16 ulp, 2^-7 relative, where an
  f32 GRU output sits at a rounding boundary) and scores within 2e-3 (those
  ulps through the towers and the sigmoid);
- last_update exact (copied event times)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.streaming import init_tppr_state
from zebra_tpu.models.memory import init_memory
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu.serve import LinkPredictor as JaxLinkPredictor
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.serve import LinkPredictor

B = 40


def _pair(dtype):
    data, ef = synthetic_stream(200, 30, 30, edge_dim=8, seed=0)
    jcfg = JaxConfig(
        node_dim=16, time_dim=16, memory_dim=16, topk=5,
        alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95),
        n_nodes=int(max(data.sources.max(), data.destinations.max())) + 1,
        n_edges=int(data.edge_idxs.max()) + 1, edge_dim=8,
        memory_dtype=dtype, message_dtype=dtype,
    )
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    jp = init_tgn_params(jax.random.PRNGKey(0), jcfg)
    jmem = init_memory(jcfg.n_nodes, jcfg.memory_dim, jcfg.msg_table_dim,
                       msg_dtype=jnp.dtype(dtype), mem_dtype=jnp.dtype(dtype))
    jidx = init_tppr_state(jcfg.n_tppr, jcfg.n_nodes, jcfg.topk)
    port = LinkPredictor(
        cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        bridge.memory_from_numpy(jax.tree.map(np.asarray, jmem), cfg, "cpu"),
        bridge.tppr_from_numpy(jax.tree.map(np.asarray, jidx), "cpu"),
        ef, device="cpu",
    )
    ref = JaxLinkPredictor(jcfg, jp, jmem, jidx, jnp.asarray(ef))
    return data, ref, port


@pytest.mark.parametrize("dtype,mem_atol,score_atol", [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 1e-2, 2e-3),
])
def test_observe_then_score_matches_jax(dtype, mem_atol, score_atol):
    data, ref, port = _pair(dtype)
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs)
    for lo in range(0, 3 * B, B):
        batch = [c[lo: lo + B] for c in cols]
        ref.observe(*batch)
        port.observe(*batch)

    m, k = ref.cfg.n_tppr, ref.cfg.topk
    split = lambda d: (d[:, : 4 * m * k].reshape(-1, m, 4, k),
                       d[:, 4 * m * k:])
    assert_entries_close(
        *split(bridge.tppr_to_numpy(port.index_state).data),
        *split(np.asarray(ref.index_state.data)))

    got, want = bridge.memory_to_numpy(port.mem), ref.mem
    assert port.mem.memory.dtype == getattr(torch, dtype)
    assert np.abs(got.memory).max() > 0          # memory did move
    np.testing.assert_allclose(got.memory, np.asarray(want.memory, np.float32),
                               rtol=0, atol=mem_atol)
    np.testing.assert_array_equal(got.last_update,
                                  np.asarray(want.last_update))
    np.testing.assert_array_equal(got.messages,
                                  np.asarray(want.messages, np.float32))

    q = slice(3 * B, 4 * B)
    p_scores = port.score(cols[0][q], cols[1][q], cols[2][q])
    r_scores = np.asarray(ref.score(cols[0][q], cols[1][q], cols[2][q]))
    assert p_scores.shape == (B,) and np.isfinite(p_scores).all()
    np.testing.assert_allclose(p_scores, r_scores, rtol=0, atol=score_atol)


def test_score_is_read_only():
    data, _, port = _pair("bfloat16")
    port.observe(data.sources[:B], data.destinations[:B],
                 data.timestamps[:B], data.edge_idxs[:B])
    index = port.index_state.data.clone()
    memory = port.mem.memory.clone()
    port.score(data.sources[B:2 * B], data.destinations[B:2 * B],
               data.timestamps[B:2 * B])
    torch.testing.assert_close(port.index_state.data, index, rtol=0, atol=0)
    torch.testing.assert_close(port.mem.memory, memory, rtol=0, atol=0)
