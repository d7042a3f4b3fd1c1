"""The superchunk wave scan's kernel binding and plain version
(zebra_tpu_torch/index/wave_kernel.py, index/waves.py): the wrapper's
refusals, the plan's device fields that the kernel reads, the plain wave
scan against the JAX package's ``wave_scan_chunk``, and the CPU dispatch.
The kernel itself (csrc/santa_waves.cu) runs only on the card, where
``chip_smoke.py`` holds it bit for bit against the plain version.

Bar against JAX: the merge tests' (``assert_entries_close``: identical
entry sets, weights within 1e-5 relative, as tests/test_pallas_merge.py
holds the Pallas kernel), on the table and on the extraction rows in
stream order, whose invalid events' rows are zero in both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from zebra_tpu.index.streaming import TpprParams as JaxTpprParams
from zebra_tpu.index.streaming import TpprState as JaxTpprState
from zebra_tpu.index.waves import wave_flat_index as jax_wave_flat_index
from zebra_tpu.index.waves import wave_scan_chunk as jax_wave_scan_chunk
from zebra_tpu_torch.index import merge as pm
from zebra_tpu_torch.index import wave_kernel, waves
from zebra_tpu_torch.index.layout import split_rows
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    _columns,
    init_tppr_state,
)

N_NODES, M, K, CAP = 200, 2, 5, 16
ALPHA, BETA = (0.1, 0.2), (0.05, 0.95)


def _stream(seed, n=400, n_seeds=1):
    """Events on N_NODES nodes with self-loops (every 13th), invalid
    events (every 11th and the last 20) and, every 5th event, a source
    that is the previous event's first negative: a write after a read,
    which the schedule may put in the reader's wave. Returns (src, dst,
    neg [E] or [E, S], t, eidx, valid)."""
    rs = np.random.RandomState(seed)
    src, dst = (rs.randint(0, N_NODES, n).astype(np.int32) for _ in range(2))
    neg = rs.randint(0, N_NODES, (n, n_seeds)).astype(np.int32)
    i = np.arange(5, n, 5)
    src[i] = neg[i - 1, 0]
    dst[::13] = src[::13]
    t = np.cumsum(rs.exponential(1.0, n)).astype(np.float32)
    eidx = np.arange(1, n + 1, dtype=np.int32)
    valid = np.ones(n, bool)
    valid[3::11] = False
    valid[-20:] = False
    if n_seeds == 1:
        neg = neg[:, 0].copy()
    return src, dst, neg, t, eidx, valid


def _same_wave_write_after_read(plan, src, dst, neg):
    """Pairs of lanes (i, j) of one wave, i before j, where lane j writes a
    row that lane i reads as a negative."""
    order, negs = plan.order.numpy(), neg.reshape(len(src), -1)
    pairs = []
    for lo, hi in zip(plan.bounds[:-1], plan.bounds[1:]):
        lanes = order[lo:hi]
        for a, i in enumerate(lanes):
            for j in lanes[a + 1:]:
                if set(negs[i]) & {int(src[j]), int(dst[j])}:
                    pairs.append((int(i), int(j)))
    return pairs


def _plain(cols, params):
    src, dst, neg, t, eidx, valid = cols
    plan = waves.plan_waves(src, dst, neg, valid, N_NODES, CAP, "cpu")
    state = init_tppr_state(M, N_NODES, K, "cpu")
    state, rows = waves.wave_scan_chunk(state, params, src, dst, neg, t, eidx,
                                        valid, plan)
    return plan, state, rows


@pytest.mark.parametrize("n_seeds", [1, 3])
def test_plain_wave_scan_matches_jax(n_seeds):
    """R = 3 and R = 2 + S, on a stream whose waves hold same-wave
    write-after-read pairs, self-loops and invalid events."""
    cols = _stream(n_seeds, n_seeds=n_seeds)
    src, dst, neg, t, eidx, valid = cols
    params = TpprParams.create(ALPHA, BETA, K)
    plan, state, rows = _plain(cols, params)
    assert _same_wave_write_after_read(plan, src, dst, neg)
    assert (src[valid] == dst[valid]).any()
    assert rows.shape == (len(src), 2 + n_seeds, state.data.shape[1])
    assert not rows[~torch.from_numpy(valid)].any()

    flat_v, n_waves = jax_wave_flat_index(
        src[valid], dst[valid], neg[valid].T, N_NODES, CAP)
    flat = np.full(len(src), n_waves * CAP, np.int32)
    flat[valid] = flat_v
    jstate = JaxTpprState(jnp.zeros((N_NODES, M * (4 * K + 1)), jnp.float32))
    jstate, jrows = jax_wave_scan_chunk(
        jstate, JaxTpprParams.create(ALPHA, BETA, K),
        *(jnp.asarray(a) for a in (src, dst, neg, t, eidx, valid, flat)),
        n_waves, CAP)
    assert np.asarray(jrows).shape == tuple(rows.shape)
    assert not np.asarray(jrows)[~valid].any()
    for got, want in ((state.data, np.asarray(jstate.data)),
                      (rows, np.asarray(jrows))):
        gf, gn = split_rows(got, M, K)
        wf, wn = split_rows(torch.from_numpy(np.array(want)), M, K)
        assert_entries_close(gf.numpy(), gn.numpy(), wf.numpy(), wn.numpy())


@pytest.mark.parametrize("n_seeds,cap", [(1, 16), (3, 4), (1, 1)])
def test_plan_device_fields(n_seeds, cap):
    """``order32`` and ``bounds32`` are i32 copies of ``order`` and
    ``bounds``; no wave holds more than ``cap`` lanes; ``width`` is the
    widest wave."""
    src, dst, neg, _, _, valid = _stream(7, n_seeds=n_seeds)
    plan = waves.plan_waves(src, dst, neg, valid, N_NODES, cap, "cpu")
    assert plan.order32.dtype == plan.bounds32.dtype == torch.int32
    assert plan.order32.is_contiguous() and plan.bounds32.is_contiguous()
    assert torch.equal(plan.order32.long(), plan.order)
    assert plan.bounds32.tolist() == list(plan.bounds)
    widths = np.diff(plan.bounds)
    assert plan.bounds[0] == 0 and plan.bounds[-1] == valid.sum()
    assert (widths > 0).all() and (widths <= cap).all()
    assert plan.width == widths.max()
    assert plan.own_pos is None and plan.own_rows is None


def test_plan_of_no_valid_event():
    src, dst, neg, _, _, _ = _stream(2, n=30)
    plan = waves.plan_waves(src, dst, neg, np.zeros(30, bool), N_NODES, CAP,
                            "cpu")
    assert plan.n_waves == plan.width == 0 and plan.order32.numel() == 0
    assert plan.bounds32.tolist() == [0]
    assert (plan.inv == 0).all()


def _kernel_args(n_seeds=1):
    """Valid arguments of ``SANTA_WAVES`` on the CPU: (data, params,
    columns, plan, ext)."""
    src, dst, neg, t, eidx, valid = _stream(5, n=40, n_seeds=n_seeds)
    plan = waves.plan_waves(src, dst, neg, valid, N_NODES, CAP, "cpu")
    data = init_tppr_state(M, N_NODES, K, "cpu").data
    cols = _columns(data, src, dst, neg, t, eidx, valid)
    ext = torch.empty((40, 2 + n_seeds, data.shape[1]))
    return data, TpprParams.create(ALPHA, BETA, K), cols, plan, ext


def _call(data, params, cols, plan, ext):
    src, dst, neg, t, eidx, valid = cols
    return wave_kernel.SANTA_WAVES(data, params, src, dst, neg, t, eidx,
                                   valid, plan, ext)


def _bad(what):
    """``_kernel_args`` with one argument broken as ``what`` names."""
    data, params, cols, plan, ext = _kernel_args(3 if what == "R" else 1)
    cols = list(cols)
    if what == "data dtype":
        data = data.double()
    elif what == "data width":
        data = data[:, :-1].contiguous()
    elif what == "data strides":
        data = torch.empty(data.shape[1], data.shape[0]).t()
    elif what == "src dtype":
        cols[0] = cols[0].long()
    elif what == "dst length":
        cols[1] = cols[1][:-1]
    elif what == "neg strides":
        cols[2] = torch.stack([cols[2], cols[2]], 1)[:, 0]
    elif what == "ts dtype":
        cols[3] = cols[3].double()
    elif what == "valid dtype":
        cols[5] = cols[5].to(torch.uint8)
    elif what == "order dtype":
        plan = plan._replace(order32=plan.order)
    elif what == "bounds length":
        plan = plan._replace(bounds32=plan.bounds32[:-1])
    elif what == "plan events":
        plan = plan._replace(bounds=plan.bounds[:-1] + (plan.bounds[-1] - 1,))
    elif what == "ext width":
        ext = ext[:, :, :-1]
    elif what == "ext strides":
        ext = ext.transpose(0, 1).contiguous().transpose(0, 1)
    elif what == "R":
        ext = torch.empty((40, 3, data.shape[1]))
    return data, params, cols, plan, ext


@pytest.mark.parametrize("what", [
    "data dtype", "data width", "data strides", "src dtype", "dst length",
    "neg strides", "ts dtype", "valid dtype", "order dtype", "bounds length",
    "plan events", "ext width", "ext strides", "R"])
def test_wrapper_refuses_bad_arguments(what):
    before = wave_kernel.SANTA_WAVES.launches
    with pytest.raises(ValueError):
        _call(*_bad(what))
    assert wave_kernel.SANTA_WAVES.launches == before


@pytest.mark.parametrize("n_seeds", [1, 3])
def test_wrapper_refuses_cpu_tensors(n_seeds):
    before = wave_kernel.SANTA_WAVES.launches
    with pytest.raises(ValueError, match="runs on cuda tensors"):
        _call(*_kernel_args(n_seeds))
    assert wave_kernel.SANTA_WAVES.launches == before


def test_wrapper_refuses_members_and_k_past_its_limits():
    data, _, cols, plan, ext = _kernel_args()
    with pytest.raises(ValueError, match="k ≤ 64"):
        _call(data, TpprParams.create(ALPHA, BETA, 65), cols, plan, ext)


def test_cpu_tensor_runs_the_loop_and_launches_nothing(monkeypatch):
    """The CPU dispatch is the plain loop (one plain merge per wave),
    whatever the kernel's binding would do."""
    def refuse(*args):
        raise AssertionError("a kernel launched for a CPU tensor")

    for kernel in (wave_kernel.SANTA_WAVES, pm.SANTA_MERGE):
        monkeypatch.setattr(kernel, "launch", refuse)
    calls = []
    real = pm.merge_both_reference
    monkeypatch.setattr(pm, "merge_both_reference",
                        lambda rows, *a: calls.append(rows.shape[0])
                        or real(rows, *a))
    before = (wave_kernel.SANTA_WAVES.launches, pm.SANTA_MERGE.launches)
    cols = _stream(4)
    params = TpprParams.create(ALPHA, BETA, K)
    plan, state, rows = _plain(cols, params)
    assert calls == list(np.diff(plan.bounds))
    assert (wave_kernel.SANTA_WAVES.launches,
            pm.SANTA_MERGE.launches) == before

    # the named plain version gives the same bits with either merge
    src, dst, neg, t, eidx, valid = cols
    for merge in (None, real):
        data = init_tppr_state(M, N_NODES, K, "cpu").data
        got = waves.wave_scan_reference(
            data, params, *_columns(data, src, dst, neg, t, eidx, valid)[:5],
            plan, merge=merge)
        assert torch.equal(got, rows) and torch.equal(data, state.data)
