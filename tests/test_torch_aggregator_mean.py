"""The mean aggregator (``--aggregator mean``) of the port against the JAX
package's: the message table accumulates every message of a sender in the
table's dtype, ``msg_count`` counts them, ``msg_ts`` keeps the newest time,
and the commit divides by the count in f32.

Bars:
- the store, from the same memory state with pending rows: both add a
  sender's messages one by one in batch order, each add rounded to the
  table's dtype, so counts, timestamps and flags are bit-equal, bf16
  message rows too, and f32 message rows agree within 1e-6 (the time
  encoding's cosine rounds apart by an ulp, measured 9.5e-7); the cell
  input of every row within 1e-6;
- the train protocol (commit, store, flush) and two train or eval batches
  of ``run_phase`` from the same params and memory: the bars of
  test_torch_train.py (loss, metrics and params within 1e-5 at f32 and
  1e-4 at bf16, relative to each tensor's largest entry, or for a param
  within 3e-3·lr: Adam normalises each step, so a weight whose gradient is
  near zero moves by a share of lr that follows the gradient's last bits;
  measured 2.97e-6 = 1e-3·lr under the message-source flags, whose second
  batch reads the first's embeddings; memory within
  1e-6 at f32 and one bf16 ulp; times and counts exact), except that the
  f32 message rows of run_phase, sums of up to three messages each within
  1e-6, are held within 3e-6 (measured 1.3e-6);
- an epoch with validate() and test() against the JAX Trainer from the
  same params, dropout 0, f32 tables: every phase's loss, AP, AUC and
  accuracy within 1e-4, the params within 1e-4 of each tensor's largest
  entry (test_torch_trainer.py's bars).

Port only: eval stores then commits under mean (the fused form refuses
it); lane 1 of ``parallel_runs=2`` equals a single-seed Trainer with seed
1 within 1e-5 (test_torch_seed_trainer.py's bar and lr 1e-3: at 3e-3 Adam
amplifies the lanes' summation-order differences to 6e-4 in six steps,
as it does there)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_train import (
    BARS,
    TABLE_ATOL,
    _close,
    _memory,
    _params,
    _protocol_batch,
    _rows,
)
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.models import tgn as jtgn
from zebra_tpu.train import phase as jphase
from zebra_tpu.train import step as jstep
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.models import tgn
from zebra_tpu_torch.train import phase, step
from zebra_tpu_torch.train.graphs import Bound
from zebra_tpu_torch.train.loop import Trainer

B = 40
SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), lr=3e-3)
PHASES = ("train", "val", "nn_val", "test", "nn_test")
# Adam normalises each step: a weight whose gradient is near zero moves by
# a share of lr that follows the gradient's last bits
ADAM_ATOL = 3e-3


def _cfgs(dtype, **kw):
    """(JAX config, port config) of the batch-level tests: mean unless
    ``kw`` says otherwise."""
    kw = {"aggregator": "mean", **kw}
    jcfg = JaxConfig(node_dim=16, time_dim=16, memory_dim=16, topk=5,
                     alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), bs=B,
                     lr=3e-3, dropout=0.0, n_nodes=64, n_edges=401,
                     edge_dim=8, memory_dtype=dtype, message_dtype=dtype,
                     **kw)
    return jcfg, Config.from_dict(dataclasses.asdict(jcfg))


def _tables_equal(pmem, jmem, atol=0.0, rtol=0.0):
    for f in ("memory", "messages"):
        np.testing.assert_allclose(bridge.to_numpy(getattr(pmem, f)),
                                   np.asarray(getattr(jmem, f), np.float32),
                                   rtol=rtol, atol=atol, err_msg=f)
    for f in ("last_update", "msg_ts", "msg_count"):
        np.testing.assert_array_equal(bridge.to_numpy(getattr(pmem, f)),
                                      np.asarray(getattr(jmem, f)), f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_store_accumulates_like_jax(dtype, masked):
    """Two stores onto a state with pending rows: repeated senders (the
    case of tests/test_aggregators.py:34-60 at scale), a self-loop and, when
    ``masked``, a padded tail; then the cell input of every row."""
    jcfg, cfg = _cfgs(dtype)
    jp, pp = _params(jcfg)
    jmem, pmem = _memory(cfg, dtype)
    ef = np.random.RandomState(4).randn(401, 8).astype(np.float32)
    for seed in (3, 5):
        src, dst, t, eidx, valid = _protocol_batch(cfg.n_nodes, seed)
        t = t + 100.0 * seed
        if not masked:
            valid[:] = True
        jmem = jax.jit(jstep._store_messages, static_argnums=0)(
            jcfg, jp, jmem, jnp.asarray(ef),
            *(jnp.asarray(a) for a in (src, dst, t, eidx, valid)))
        step._store_messages(cfg, pp, pmem, torch.from_numpy(ef),
                             *(torch.from_numpy(a) for a in (src, dst, t,
                                                             eidx)),
                             torch.from_numpy(valid) if masked else None)
    _tables_equal(pmem, jmem, 1e-6 if dtype == "float32" else 0.0)
    assert float(pmem.msg_count.max()) >= 3.0
    want, wflag = jtgn.message_input(jcfg, jp, jmem, None)
    with torch.no_grad():
        got, flag = tgn.message_input(cfg, pp, pmem, None)
    np.testing.assert_array_equal(flag.numpy(), np.asarray(wflag))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_protocol_matches_jax(dtype):
    """_commit_pending, _store_messages, then flush_pending under mean."""
    jcfg, cfg = _cfgs(dtype)
    jp, pp = _params(jcfg)
    jmem, pmem = _memory(cfg, dtype)
    ef = np.random.RandomState(4).randn(401, 8).astype(np.float32)
    src, dst, t, eidx, valid = _protocol_batch(cfg.n_nodes)
    v2 = np.concatenate([valid, valid])
    pos = np.concatenate([src, dst])
    jm = jax.jit(jstep._commit_pending, static_argnums=0)(
        jcfg, jp, jmem, jnp.asarray(pos), jnp.asarray(v2))
    jm = jax.jit(jstep._store_messages, static_argnums=0)(
        jcfg, jp, jm, jnp.asarray(ef),
        *(jnp.asarray(a) for a in (src, dst, t, eidx, valid)))
    jf = jax.jit(jstep.flush_pending_impl, static_argnums=0)(jcfg, jp, jm)
    tv = torch.from_numpy
    step._commit_pending(cfg, pp, pmem, tv(pos), tv(v2))
    step._store_messages(cfg, pp, pmem, tv(ef), tv(src), tv(dst), tv(t),
                         tv(eidx), tv(valid))
    _tables_equal(pmem, jm, TABLE_ATOL[dtype])
    _tables_equal(step.flush_pending(cfg, pp, pmem), jf, TABLE_ATOL[dtype])


def check_run_phase(dtype, train, **kw):
    """Two batches, the second with a padded tail, through JAX's phase
    program and the port's run_phase from the same params and memory, at
    the options ``kw`` (mean unless they say otherwise): metrics, params
    and tables at this file's bars."""
    jcfg, cfg = _cfgs(dtype, **kw)
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
    stream = phase.Stream(**{k: torch.from_numpy(v) for k, v in cols.items()})
    bound = Bound(cfg, pp, pmem, torch.from_numpy(ef), None, None)
    ms = phase.run_phase(bound, train, step.make_optimizer(cfg, pp), stream,
                         torch.from_numpy(rows), [B, B - 9]).metrics
    bar = BARS[dtype]
    for i, name in enumerate(phase.METRICS):
        _close(ms[:, i], getattr(j_ms, name), bar)
    for name, layer in pp.items():
        for key, p in layer.items():
            want = np.asarray(j_p[name][key])
            err = np.abs(bridge.to_numpy(p) - want).max()
            assert err <= max(bar * np.abs(want).max(), ADAM_ATOL * cfg.lr), (
                name, key, err)
    # an f32 message sum holds up to three messages, each within 1e-6
    _tables_equal(pmem, j_mem, 3 * TABLE_ATOL[dtype] if dtype == "float32"
                  else TABLE_ATOL[dtype])


@pytest.mark.parametrize("dtype,train", [("float32", True),
                                         ("float32", False),
                                         ("bfloat16", True)])
def test_run_phase_matches_jax(dtype, train):
    """train (a step, commit, store) or eval (store then commit)."""
    check_run_phase(dtype, train)


def test_eval_stores_then_commits_under_mean():
    """The fused eval protocol is for ``last`` only, as JAX asserts; under
    mean eval_protocol stores then commits, and under last the two forms
    give the same tables."""
    _, cfg = _cfgs("bfloat16")
    _, pp = _params(_cfgs("bfloat16")[0])
    ef = torch.from_numpy(np.random.RandomState(4).randn(401, 8)
                          .astype(np.float32))
    batch = [torch.from_numpy(a) for a in _protocol_batch(cfg.n_nodes)]
    with pytest.raises(ValueError, match="aggregator='mean'"):
        step.eval_store_commit(cfg, pp, _memory(cfg, "bfloat16")[1], ef,
                               *batch)
    last = cfg.replace(aggregator="last")
    fused, split = _memory(last, "bfloat16")[1], _memory(last, "bfloat16")[1]
    step.eval_protocol(last, pp, fused, ef, *batch)
    step.eval_store_then_commit(last, pp, split, ef, *batch)
    for a, b in zip(fused, split):
        assert torch.equal(a, b)
    mean = _memory(cfg, "bfloat16")[1]
    step.eval_protocol(cfg, pp, mean, ef, *batch)
    assert not torch.equal(mean.memory, fused.memory)
    src, dst, _, _, valid = batch
    senders = torch.cat([src[valid], dst[valid]]).long()
    assert float(mean.msg_count[senders].abs().sum()) == 0.0


def _stream():
    data, ef = synthetic_stream(n_events=600, n_users=30, n_items=30,
                                edge_dim=4, seed=0)
    return (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels), ef


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(zip(PHASES, (tr, val, nn_val, test, nn_test)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cols, ef = _stream()
    jcfg = JaxConfig(**SMALL, dropout=0.0, aggregator="mean",
                     memory_dtype="float32", message_dtype="float32",
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    return jt, pt, _run(jt), _run(pt)


@pytest.mark.parametrize("phase_name", PHASES)
def test_epoch_metrics_match_jax(pair, phase_name):
    _, _, jres, pres = pair
    for f in ("loss", "ap", "auc", "acc"):
        got, want = getattr(pres[phase_name], f), getattr(jres[phase_name], f)
        assert abs(got - want) <= 1e-4, (f, got, want)


def test_params_after_epoch_match_jax(pair):
    jt, pt, _, _ = pair
    want = jax.tree.map(np.asarray, jt.params)
    for name, layer in bridge.params_to_numpy(pt.params).items():
        for key, got in layer.items():
            w = want[name][key]
            assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), (name,
                                                                      key)


def test_seed_lane_equals_a_single_seed_trainer(tmp_path):
    cols, ef = _stream()
    kw = dict(SMALL, aggregator="mean", dropout=0.1, lr=1e-3,
              memory_dtype="float32", message_dtype="float32",
              checkpoint_dir=str(tmp_path))
    par = Trainer(Config(**kw, parallel_runs=2), split_data(*cols), ef,
                  device="cpu")
    one = Trainer(Config(**kw, seed=1), split_data(*cols), ef, device="cpu")
    rp, r1 = par.train_epoch(), one.train_epoch()
    np.testing.assert_allclose(rp.per_batch[:, 1], r1.per_batch, rtol=0,
                               atol=1e-5)
    vp, v1 = par.validate()[0], one.validate()[0]
    for f in ("ap", "auc", "acc"):
        assert abs(getattr(vp, f)[1] - getattr(v1, f)) <= 1e-5, f
    for key, v in one.params.state_dict().items():
        d = (par.params.state_dict()[key][1] - v).abs().max()
        assert float(d) <= 1e-5, key
