"""The port's model stack (zebra_tpu_torch/models, train/step.py, bridge.py,
data/synthetic.py) against the JAX package at identical parameters and
inputs, copied across through numpy.

Tolerances: f32 results differ only by summation order inside matrix
products (rtol 1e-5); bf16 memory tables can differ by one bf16 ulp where
an f32 result sits at a rounding boundary (2^-7 relative, so atol 1e-2 on
values of magnitude below one)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.synthetic import synthetic_stream as jax_synthetic_stream
from zebra_tpu.models import cells as jcells
from zebra_tpu.models import tgn as jtgn
from zebra_tpu.models import time_encoding as jte
from zebra_tpu.models.memory import MemoryState as JaxMemoryState
from zebra_tpu.train import step as jstep
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.models import cells, tgn
from zebra_tpu_torch.models import time_encoding as te
from zebra_tpu_torch.train import step

SMALL = dict(node_dim=16, time_dim=16, memory_dim=16, topk=5,
             alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), n_nodes=60,
             n_edges=90, edge_dim=8)


def configs(**kw):
    jcfg = JaxConfig(**{**SMALL, **kw})
    return jcfg, Config.from_dict(dataclasses.asdict(jcfg))


def params_pair(jcfg, seed=0):
    jp = jtgn.init_tgn_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(bridge.to_numpy(got),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def test_time_encoding_matches_jax():
    rng = np.random.RandomState(0)
    dt = (rng.rand(7, 5) * 1.2e5).astype(np.float32)
    np.testing.assert_array_equal(te.time_basis(100).numpy(),
                                  np.asarray(jte.time_basis(100)))
    close(te.time_encode(t(dt), te.time_basis(100)),
          jte.time_encode(jnp.asarray(dt), jte.time_basis(100)), atol=2e-6)


@pytest.mark.parametrize("cell", ["gru", "rnn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_matches_jax(cell, dtype):
    """f32 inputs, and the bf16 form the memory protocol runs (a bf16
    message and bf16 hidden state against f32 weights)."""
    rng = np.random.RandomState(1)
    jinit, japply = jcells.CELLS[cell]
    jp = jinit(jax.random.PRNGKey(2), 24, 16)
    pp = bridge.params_from_numpy({"c": jax.tree.map(np.asarray, jp)},
                                  device="cpu")["c"]
    x = jnp.asarray(rng.randn(9, 24), dtype)
    h = jnp.asarray(rng.rand(9, 16) - 0.5, dtype)
    px, ph = (bridge.to_tensor(np.asarray(a), "cpu") for a in (x, h))
    assert px.dtype == getattr(torch, dtype)
    _, papply = cells.CELLS[cell]
    got = papply(pp, px, ph)
    assert got.dtype == torch.float32
    close(got, japply(jp, x, h))


def test_bf16_matmul_is_exact_f32_product_of_rounded_operands():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(5, 32).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
    got = cells.matmul(x, w)
    assert got.dtype == torch.float32
    want = x.double() @ w.bfloat16().double()
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    jwant = jcells.matmul(jnp.asarray(bridge.to_numpy(x), jnp.bfloat16),
                          jnp.asarray(w.numpy()))
    close(got, jwant)


def _queries(cfg, q_rows, seed):
    rng = np.random.RandomState(seed)
    m, k = cfg.n_tppr, cfg.topk
    nbr = rng.randint(0, cfg.n_nodes, (m, q_rows, k)).astype(np.int32)
    eidx = rng.randint(0, cfg.n_edges + 5, (m, q_rows, k)).astype(np.int32)
    dt = (rng.rand(m, q_rows, k) * 1e3).astype(np.float32)
    w = rng.rand(m, q_rows, k).astype(np.float32)
    w[:, ::4] = 0.0                  # empty rows: the zero-sum guard
    return nbr, eidx, dt, w


@pytest.mark.parametrize("mem_dtype,compute_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16"),
])
def test_diffusion_embed_and_affinity_match_jax(mem_dtype, compute_dtype):
    jcfg, cfg = configs(memory_dtype=mem_dtype, compute_dtype=compute_dtype)
    jp, pp = params_pair(jcfg)
    rng = np.random.RandomState(4)
    ef = rng.randn(cfg.n_edges, cfg.edge_dim).astype(np.float32)
    memory = jnp.asarray(rng.rand(cfg.n_nodes, 16) - 0.5, mem_dtype)
    q = 12
    nodes = rng.randint(0, cfg.n_nodes, q).astype(np.int32)
    nbr, eidx, dt, w = _queries(cfg, q, 5)

    j_static = jax.jit(jtgn.diffusion_static_input, static_argnums=0)(
        jcfg, jnp.asarray(ef), jnp.asarray(eidx), jnp.asarray(dt))
    p_static = tgn.diffusion_static_input(cfg, t(ef), t(eidx), t(dt))
    close(p_static, j_static)

    pmem = bridge.to_tensor(np.asarray(memory), "cpu")
    j_emb = jax.jit(jtgn.diffusion_embed, static_argnums=(0, 6, 7))(
        jcfg, jp, memory[nodes], memory[nbr], j_static, jnp.asarray(w), None,
        False)
    p_emb = tgn.diffusion_embed(cfg, pp, pmem[t(nodes)], pmem[t(nbr)],
                                p_static, t(w))
    assert p_emb.shape == (q, cfg.hidden_dim)
    close(p_emb, j_emb)

    half = q // 2
    close(tgn.affinity_score(pp, p_emb[:half], p_emb[half:]),
          jtgn.affinity_score(jp, j_emb[:half], j_emb[half:]))


def _memory_pair(jcfg, cfg, seed):
    """A random memory state (pending flags on some rows), JAX and port."""
    rng = np.random.RandomState(seed)
    n = cfg.n_nodes
    msgs = rng.rand(n, cfg.msg_table_dim + 1).astype(np.float32) - 0.5
    msgs[:, -1] = rng.rand(n) < 0.5
    jmem = JaxMemoryState(
        memory=jnp.asarray(rng.rand(n, 16) - 0.5, jcfg.memory_dtype),
        last_update=jnp.asarray(rng.rand(n) * 50, jnp.float32),
        messages=jnp.asarray(msgs, jcfg.message_dtype),
        msg_ts=jnp.asarray(rng.rand(n) * 50, jnp.float32),
        msg_count=jnp.asarray(rng.rand(n) < 0.5, jnp.float32),
    )
    return jmem, bridge.memory_from_numpy(
        jax.tree.map(np.asarray, jmem), cfg, device="cpu")


def assert_memory_close(pmem, jmem, mem_atol):
    got = bridge.memory_to_numpy(pmem)
    want = jax.tree.map(lambda x: np.asarray(x, np.float32), jmem)
    np.testing.assert_allclose(got.memory, want.memory, rtol=1e-5,
                               atol=mem_atol)
    for f in ("last_update", "messages", "msg_ts", "msg_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_store_commit_matches_jax(dtype):
    """Duplicate senders (last wins), invalid events and fresh edge ids past
    the feature table, on both table dtypes."""
    jcfg, cfg = configs(memory_dtype=dtype, message_dtype=dtype)
    jp, pp = params_pair(jcfg, seed=1)
    jmem, pmem = _memory_pair(jcfg, cfg, seed=6)
    rng = np.random.RandomState(7)
    b = 20
    src = rng.randint(1, 12, b).astype(np.int32)
    dst = rng.randint(1, cfg.n_nodes, b).astype(np.int32)
    tt = np.sort(50 + rng.rand(b) * 10).astype(np.float32)
    eidx = rng.randint(1, cfg.n_edges + 10, b).astype(np.int32)
    valid = rng.rand(b) < 0.8
    ef = rng.randn(cfg.n_edges, cfg.edge_dim).astype(np.float32)
    jout = jax.jit(jstep.eval_store_commit, static_argnums=0)(
        jcfg, jp, jmem, jnp.asarray(ef), *(jnp.asarray(a) for a in
                                           (src, dst, tt, eidx, valid)))
    pout = step.eval_store_commit(cfg, pp, pmem, t(ef), t(src), t(dst),
                                  t(tt), t(eidx), t(valid))
    assert pout.memory.dtype == getattr(torch, dtype)
    assert_memory_close(pout, jout, 1e-5 if dtype == "float32" else 1e-2)


def test_bridge_round_trips():
    jcfg, cfg = configs()
    jp, pp = params_pair(jcfg)
    back = bridge.params_to_numpy(pp)
    for name, layer in jax.tree.map(np.asarray, jp).items():
        for key, v in layer.items():
            np.testing.assert_array_equal(back[name][key], v)
    jmem, pmem = _memory_pair(jcfg, cfg, seed=8)
    assert pmem.memory.dtype == torch.bfloat16
    assert pmem.messages.dtype == torch.bfloat16
    np_mem = bridge.memory_to_numpy(pmem)
    for f in JaxMemoryState._fields:
        np.testing.assert_array_equal(
            getattr(np_mem, f), np.asarray(getattr(jmem, f), np.float32))
    again = bridge.memory_from_numpy(np_mem, cfg, device="cpu")
    for a, b in zip(again, pmem):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    data = np.random.RandomState(9).rand(5, 2 * (4 * 5 + 1)).astype(np.float32)
    state = bridge.tppr_from_numpy(type("S", (), {"data": data}), "cpu")
    np.testing.assert_array_equal(bridge.tppr_to_numpy(state).data, data)


@pytest.mark.parametrize("kw", [
    dict(n_events=500, n_users=40, n_items=30, edge_dim=8, seed=0),
    dict(n_events=300, n_users=5, n_items=3, edge_dim=0, seed=3,
         label_users_frac=0.3),
])
def test_synthetic_stream_matches_jax(kw):
    got, got_ef = synthetic_stream(**kw)
    want, want_ef = jax_synthetic_stream(**kw)
    for f in ("sources", "destinations", "timestamps", "edge_idxs", "labels"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    if want_ef is None:
        assert got_ef is None
    else:
        np.testing.assert_array_equal(got_ef, want_ef)


def test_init_params_layout_matches_jax():
    """Same keys, [in, out] shapes and dtypes as the JAX init; a seed gives
    the same weights; Xavier-normal weights have the Xavier spread."""
    jcfg, cfg = configs()
    jp = jtgn.init_tgn_params(jax.random.PRNGKey(0), jcfg)
    pp = tgn.init_tgn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(pp.keys()) == set(jp.keys())
    for name, layer in jp.items():
        assert set(pp[name].keys()) == set(layer.keys()), name
        for key, v in layer.items():
            assert tuple(pp[name][key].shape) == v.shape, (name, key)
            assert pp[name][key].dtype == torch.float32
    again = tgn.init_tgn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    torch.testing.assert_close(again["fc1"]["w"], pp["fc1"]["w"], rtol=0,
                               atol=0)
    wide = tgn.init_tgn_params(
        cfg.replace(node_dim=100, memory_dim=100, time_dim=100, edge_dim=172),
        torch.Generator().manual_seed(0), "cpu")
    d_in, d_out = wide["fc1"]["w"].shape
    std = float(wide["fc1"]["w"].std())
    assert std == pytest.approx((2.0 / (d_in + d_out)) ** 0.5, rel=0.05)
