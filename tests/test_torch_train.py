"""The port's train step (zebra_tpu_torch/train/step.py, train/phase.py),
its memory protocol, and its data splits and samplers against the JAX
package, at identical inputs copied across through numpy. Dropout is 0.

Bars:
- loss, every gradient, metrics, and params after Adam steps (relative to
  each tensor's largest entry): within 1e-5 at f32 tables and 1e-4 at bf16
  tables. Matrix products sum in another order and the two BCE formulas
  round apart; measured on the CPU, the gradients agree within 6e-7 at
  both dtypes and the params after two steps within 6e-7 (f32) and 7.4e-6
  (bf16), where a bf16 operand rounds the other way at a boundary;
- memory tables: within 1e-6 at f32, one bf16 ulp (1e-2 on values below
  one) at bf16; timestamps, counts and flags exact;
- splits and negatives: identical arrays."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.sampler import RandEdgeSampler as JaxSampler
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.streaming import TpprQueries as JaxQueries
from zebra_tpu.index.streaming import unpack_queries as jax_unpack
from zebra_tpu.models.memory import MemoryState as JaxMemoryState
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu.train import phase as jphase
from zebra_tpu.train import step as jstep
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.sampler import RandEdgeSampler
from zebra_tpu_torch.index.scan import scan_reference
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    _columns,
    init_tppr_state,
    streaming_scan,
)
from zebra_tpu_torch.train import phase, step
from zebra_tpu_torch.train.graphs import Bound

B = 40
BARS = {"float32": 1e-5, "bfloat16": 1e-4}
TABLE_ATOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _cfgs(dtype):
    jcfg = JaxConfig(node_dim=16, time_dim=16, memory_dim=16, topk=5,
                     alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), bs=B,
                     lr=3e-3, dropout=0.0, n_nodes=64, n_edges=401,
                     edge_dim=8, memory_dtype=dtype, message_dtype=dtype)
    return jcfg, Config.from_dict(dataclasses.asdict(jcfg))


def _rows(cfg, n_batches):
    """Extraction rows [n_batches·B, 3, F] of real events: the port's plain
    scan over 300 events of a 60-node stream, then over the batches'."""
    data, ef = synthetic_stream(400, 30, 30, edge_dim=8, seed=0)
    rng = np.random.RandomState(1)
    neg = rng.randint(1, 61, 400).astype(np.int32)
    ts = data.timestamps.astype(np.float32)
    state = init_tppr_state(cfg.n_tppr, cfg.n_nodes, cfg.topk, device="cpu")
    params = TpprParams.create(cfg.alpha_list, cfg.beta_list, cfg.topk)
    cols = (data.sources, data.destinations, neg, ts, data.edge_idxs)
    streaming_scan(state, params, *(c[:300] for c in cols),
                   np.ones(300, bool))
    e = slice(300, 300 + n_batches * B)
    c = _columns(state.data, *(x[e] for x in cols), np.ones(n_batches * B, bool))
    return ef, tuple(x[e] for x in cols), scan_reference(state.data, params,
                                                         *c).numpy()


def _memory(cfg, dtype, seed=2):
    """A memory state with pending messages on about half the rows."""
    rng = np.random.RandomState(seed)
    n = cfg.n_nodes
    msgs = (rng.rand(n, cfg.msg_table_dim + 1) - 0.5).astype(np.float32)
    msgs[:, -1] = rng.rand(n) < 0.5
    mem = JaxMemoryState(
        memory=jnp.asarray(rng.rand(n, cfg.memory_dim) - 0.5, dtype),
        last_update=jnp.asarray(rng.rand(n) * 100, jnp.float32),
        messages=jnp.asarray(msgs, dtype),
        msg_ts=jnp.asarray(100 + rng.rand(n) * 100, jnp.float32),
        msg_count=jnp.asarray(msgs[:, -1], jnp.float32),
    )
    return mem, bridge.memory_from_numpy(jax.tree.map(np.asarray, mem), cfg,
                                         "cpu")


def _params(jcfg):
    # a JAX Trainer built earlier in the process makes its prng_impl the
    # default (zebra_tpu/train/loop.py:374): pin the key's impl, so the
    # params do not depend on which tests ran before
    jp = init_tgn_params(jax.random.key(0, impl="threefry2x32"), jcfg)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, pp.requires_grad_(True)


def _close(got, want, bar, scale=False):
    got = bridge.to_numpy(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if scale:  # relative to the tensor's largest entry
        assert np.abs(got - want).max() <= bar * max(np.abs(want).max(), 1e-30)
    else:
        np.testing.assert_allclose(got, want, rtol=bar, atol=bar * 1e-2)


def _jax_queries(jcfg, rows, t):
    q = jax_unpack(jnp.asarray(rows), jnp.asarray(t), jcfg.n_tppr, jcfg.topk)
    b = rows.shape[0]
    return JaxQueries(*(x.transpose(1, 2, 0, 3).reshape(x.shape[1], 3 * b,
                                                         x.shape[3])
                        for x in q))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_gradients_match_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    ef, (src, dst, neg, ts, eidx), rows = _rows(cfg, 1)
    jmem, pmem = _memory(cfg, dtype)
    jp, pp = _params(jcfg)
    valid = np.ones(B, bool)
    valid[-7:] = False
    nodes3 = np.concatenate([src, dst, neg]).astype(np.int32)

    def jloss(p):
        emb = jstep._forward(jcfg, p, jmem, jnp.asarray(ef), jnp.asarray(nodes3),
                             None, _jax_queries(jcfg, rows, ts), (), None,
                             train=True)
        pos, negl = jstep._scores(jcfg, p, emb, B)
        v = jnp.asarray(valid)
        return (jstep._masked_mean(optax.sigmoid_binary_cross_entropy(
                    pos, jnp.ones_like(pos)), v)
                + jstep._masked_mean(optax.sigmoid_binary_cross_entropy(
                    negl, jnp.zeros_like(negl)), v))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)

    q = phase.batch_queries(cfg, torch.from_numpy(rows), torch.from_numpy(ts))
    emb = step._forward(cfg, pp, pmem, torch.from_numpy(ef),
                        torch.from_numpy(nodes3), q, train=True)
    pos, negl = step._scores(cfg, pp, emb, B)
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    v = torch.from_numpy(valid)
    loss = (step._masked_mean(bce(pos, torch.ones_like(pos), reduction="none"), v)
            + step._masked_mean(bce(negl, torch.zeros_like(negl),
                                    reduction="none"), v))
    loss.backward()
    bar = BARS[dtype]
    _close(loss, jl, bar)
    for name, layer in pp.items():
        for key, p in layer.items():
            _close(p.grad, jg[name][key], bar, scale=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_run_phase_matches_jax(dtype, train):
    """Two batches, the second with a padded tail, through JAX's _run_phase
    (the phase program with precomputed query rows) and the port's
    run_phase: metrics, params after the Adam steps, memory after the
    protocol."""
    jcfg, cfg = _cfgs(dtype)
    ef, (src, dst, neg, ts, eidx), rows = _rows(cfg, 2)
    jmem, pmem = _memory(cfg, dtype)
    jp, pp = _params(jcfg)
    valid = np.ones(2 * B, bool)
    valid[-9:] = False
    cols = dict(src=src, dst=dst, neg=neg, t=ts, eidx=eidx, valid=valid)
    jstream = jphase.Stream(**{k: jnp.asarray(v) for k, v in cols.items()})
    opt = jstep.make_optimizer(jcfg)
    j_p, _, j_mem, _, j_ms = jphase.run_phase(
        jcfg, train, 2, jp, opt.init(jp), jmem, (), jax.random.PRNGKey(0),
        jnp.asarray(ef), (), jstream, jnp.asarray(rows))

    optimizer = step.make_optimizer(cfg, pp)
    stream = phase.Stream(**{k: torch.from_numpy(v) for k, v in cols.items()})
    bound = Bound(cfg, pp, pmem, torch.from_numpy(ef), None, None)
    ms = phase.run_phase(bound, train, optimizer, stream,
                         torch.from_numpy(rows), [B, B - 9]).metrics
    bar = BARS[dtype]
    for i, name in enumerate(phase.METRICS):
        _close(ms[:, i], getattr(j_ms, name), bar)
    for name, layer in pp.items():
        for key, p in layer.items():
            _close(p, j_p[name][key], bar, scale=True)
    for f in ("memory", "messages"):
        np.testing.assert_allclose(bridge.to_numpy(getattr(pmem, f)),
                                   np.asarray(getattr(j_mem, f), np.float32),
                                   atol=TABLE_ATOL[dtype])
    for f in ("last_update", "msg_ts", "msg_count"):
        np.testing.assert_array_equal(bridge.to_numpy(getattr(pmem, f)),
                                      np.asarray(getattr(j_mem, f)))


def _protocol_batch(n_nodes, seed=3):
    """A batch with repeated senders (src and dst), a self-loop and a padded
    tail."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, 12, B).astype(np.int32)
    dst = rng.randint(1, n_nodes, B).astype(np.int32)
    dst[5] = src[5]
    t = np.sort(rng.rand(B) * 50 + 200).astype(np.float32)
    eidx = rng.randint(1, 400, B).astype(np.int32)
    valid = np.ones(B, bool)
    valid[-6:] = False
    return src, dst, t, eidx, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_memory_protocol_matches_jax(dtype, masked):
    """_commit_pending then _store_messages (the train protocol), and
    flush_pending, against JAX: with a mask, or with every event valid
    (the port's mask-free scatter)."""
    jcfg, cfg = _cfgs(dtype)
    jp, pp = _params(jcfg)
    jmem, pmem = _memory(cfg, dtype)
    ef = np.random.RandomState(4).randn(401, 8).astype(np.float32)
    src, dst, t, eidx, valid = _protocol_batch(cfg.n_nodes)
    if not masked:
        valid[:] = True
    v2 = np.concatenate([valid, valid])
    pos = np.concatenate([src, dst])

    jm = jax.jit(jstep._commit_pending, static_argnums=0)(
        jcfg, jp, jmem, jnp.asarray(pos), jnp.asarray(v2))
    jm = jax.jit(jstep._store_messages, static_argnums=0)(
        jcfg, jp, jm, jnp.asarray(ef), *(jnp.asarray(a) for a in
                                         (src, dst, t, eidx, valid)))
    jf = jax.jit(jstep.flush_pending_impl, static_argnums=0)(jcfg, jp, jm)

    tv = (lambda a: torch.from_numpy(a)) if masked else (lambda a: None)
    step._commit_pending(cfg, pp, pmem, torch.from_numpy(pos), tv(v2))
    step._store_messages(cfg, pp, pmem, torch.from_numpy(ef),
                         *(torch.from_numpy(a) for a in (src, dst, t, eidx)),
                         tv(valid))
    before = [x.clone() for x in pmem]
    pf = step.flush_pending(cfg, pp, pmem)
    for x, y in zip(before, pmem):        # the flush leaves its input alone
        assert torch.equal(x, y)
    atol = TABLE_ATOL[dtype]
    for got, want in ((pmem, jm), (pf, jf)):
        for f in JaxMemoryState._fields:
            g = bridge.to_numpy(getattr(got, f))
            w = np.asarray(getattr(want, f), np.float32)
            if f in ("memory", "messages"):
                np.testing.assert_allclose(g, w, atol=atol, err_msg=f)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)


def test_split_and_samplers_match_jax():
    data, _ = synthetic_stream(3000, 150, 150, seed=5)
    cols = (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels)
    want, got = jax_split_data(*cols), split_data(*cols)
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    for name in ("full", "train", "val", "test", "new_node_val",
                 "new_node_test"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.n_interactions == w.n_interactions, name
        for f in ("sources", "destinations", "timestamps", "edge_idxs",
                  "labels"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, (name, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")

    tr, fu = got.train, got.full
    for seed in (0, 2, 3):
        p = RandEdgeSampler(fu.sources, fu.destinations, seed=seed)
        j = JaxSampler(fu.sources, fu.destinations, seed=seed)
        np.testing.assert_array_equal(p.sample_eval_negatives(777, 200),
                                      j.sample_eval_negatives(777, 200))
    p = RandEdgeSampler(tr.sources, tr.destinations)
    j = JaxSampler(tr.sources, tr.destinations)
    for a, b in zip(p.sample_with(np.random.RandomState(9), 500),
                    j.sample_with(np.random.RandomState(9), 500)):
        np.testing.assert_array_equal(a, b)
