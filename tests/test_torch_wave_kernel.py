"""The superchunk wave scan's kernel binding and plain version
(zebra_tpu_torch/index/wave_kernel.py, index/waves.py): the wrapper's
refusals, the plan's device fields that the kernel reads, the redirect list
against a brute force, a plain model of the kernel's order within a wave,
the launch geometry, the plain wave scan against the JAX package's
``wave_scan_chunk``, and the CPU dispatch. The kernel itself
(csrc/santa_waves.cu) runs only on the card, where ``chip_smoke.py`` holds
it bit for bit against the plain version.

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
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index import merge as pm
from zebra_tpu_torch.index import wave_kernel, waves
from zebra_tpu_torch.index.layout import row_width, split_rows
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


DENSE_NODES = 301


def _dense_stream(seed, n=2000, n_seeds=1):
    """The dense stress stream of ``chip_smoke.scan_stream`` on 301 nodes:
    a synthetic 150 × 150 stream whose events share nodes all the time,
    with self-loops (every 9th event), invalid events (every 7th), the
    first negative equal to the previous event's src (every 5th) or dst
    (every 6th), and src equal to the previous dst (every 8th). Returns
    (src, dst, neg [E] or [E, S], t, eidx, valid)."""
    data, _ = synthetic_stream(n, 150, 150, seed=seed)
    src, dst = data.sources.copy(), data.destinations.copy()
    neg = np.random.RandomState(seed).randint(
        1, DENSE_NODES, (n, n_seeds)).astype(np.int32)
    valid = np.ones(n, bool)
    valid[3::7] = False
    for step, col, prev in ((8, src, dst), (5, neg[:, 0], src),
                            (6, neg[:, 0], dst)):
        i = np.arange(step // 4, n, step)
        col[i] = prev[i - 1]
    dst[::9] = src[::9]
    t = data.timestamps.astype(np.float32)
    eidx = data.edge_idxs.astype(np.int32)
    if n_seeds == 1:
        neg = neg[:, 0].copy()
    return src, dst, neg, t, eidx, valid


def _brute_redirects(plan, src, dst, neg):
    """Every (writer place, reader position, slot, src 0 / dst 1) of the
    plan's waves, lane by lane: the lanes of the reader's wave that write
    the negative's row, which must be exactly one, at or after the
    reader."""
    order, negs = plan.order.numpy(), neg.reshape(len(src), -1)
    found = set()
    for lo, hi in zip(plan.bounds[:-1], plan.bounds[1:]):
        for i in range(lo, hi):
            for r, v in enumerate(negs[order[i]]):
                writers = [(j, 0 if src[order[j]] == v else 1)
                           for j in range(lo, hi)
                           if v in (src[order[j]], dst[order[j]])]
                assert len(writers) <= 1, writers
                if writers:
                    (j, which), = writers
                    assert j >= i, (i, j)
                    found.add((j, int(order[i]), r, which))
    return found


@pytest.mark.parametrize("kind", ["random", "dense"])
@pytest.mark.parametrize("n_seeds", [1, 2, 5])
@pytest.mark.parametrize("cap", [1, 4, 64])
def test_redirect_list_matches_brute_force(kind, n_seeds, cap):
    """Each same-wave write after read (a negative whose row a lane of the
    reader's wave writes: a later lane, or the reader itself) appears once
    in ``plan.redirect`` with its writer and row; ``redirect_start`` cuts
    the list by writer and ``redirect_mask`` marks exactly the named
    negatives."""
    if kind == "random":
        cols, n_nodes = _stream(11 + n_seeds, n_seeds=n_seeds), N_NODES
    else:
        cols, n_nodes = _dense_stream(3, 600, n_seeds), DENSE_NODES
    src, dst, neg, _, _, valid = cols
    plan = waves.plan_waves(src, dst, neg, valid, n_nodes, cap, "cpu")
    rows = plan.redirect.numpy()
    got = [tuple(int(x) for x in row) for row in rows]
    assert len(got) == len(set(got))
    want = _brute_redirects(plan, src, dst, neg)
    assert set(got) == want
    if cap > 1:
        assert want, "the stream holds no same-wave write after read"
    keys = [(row[0], plan.inv[row[1]].item(), row[2]) for row in got]
    assert keys == sorted(keys)
    start = plan.redirect_start.numpy()
    assert (start == np.searchsorted(rows[:, 0],
                                     np.arange(len(plan.order) + 1))).all()
    mask = np.zeros((len(plan.order), n_seeds), np.uint8)
    for j, e, r, _ in got:
        mask[plan.inv[e], r] = 1
    assert (plan.redirect_mask.numpy() == mask).all()


def test_redirect_list_refuses_ids_out_of_range():
    src, dst, neg, _, _, valid = _stream(2, n=30)
    plan = waves.plan_waves(src, dst, neg, valid, N_NODES, CAP, "cpu")
    bad = neg.copy()
    bad[plan.order[0]] = N_NODES
    with pytest.raises(ValueError, match="out of range"):
        waves.redirects(src, dst, bad, plan.order.numpy(), plan.bounds,
                        N_NODES)


def _race_model(data, params, cols, plan, redirect):
    """The kernel's order within a wave, run on the CPU with the plain
    merge: each wave's lanes in reverse lane order, each lane whole and
    with no barrier (its src and dst rows from ``data``, its extraction
    rows 0-1 and the rows it owes its readers from those, the merge
    written straight into ``data``, then its other negatives read from
    ``data``). ``redirect`` is the plan's list, or an empty one. Returns
    the extraction rows [E, 2+S, F]."""
    src, dst, neg, t, eidx, _ = cols
    n, f = src.shape[0], data.shape[1]
    negs = neg.view(n, -1)
    ext = torch.zeros((n, 2 + negs.shape[1], f))
    order = plan.order.tolist()
    owed = {}
    for j, e, r, which in redirect.tolist():
        owed.setdefault(j, []).append((e, r, which))
    skip = {(e, r) for _, e, r, _ in redirect.tolist()}
    for lo, hi in zip(plan.bounds[:-1], plan.bounds[1:]):
        for j in reversed(range(lo, hi)):
            e = order[j]
            rows = data[torch.stack([src[e], dst[e]]).long()].clone()
            ext[e, :2] = rows
            for reader, r, which in owed.get(j, ()):
                ext[reader, 2 + r] = rows[which]
            new = pm.merge_both_reference(rows[None], src[e:e + 1],
                                          dst[e:e + 1], eidx[e:e + 1],
                                          t[e:e + 1], params)[0]
            data[src[e].long()] = new[0]
            data[dst[e].long()] = new[1]
            for r in range(negs.shape[1]):
                if (e, r) not in skip:
                    ext[e, 2 + r] = data[negs[e, r].long()]
    return ext


def _race_case(kind, n_seeds):
    """(params, warm table, columns, plan) of the race model's chunk."""
    params = TpprParams.create(ALPHA, BETA, K)
    if kind == "random":
        cols, n_nodes, warm = _stream(21, n_seeds=n_seeds), N_NODES, 0
    else:
        cols, n_nodes, warm = _dense_stream(7, 1400, n_seeds), DENSE_NODES, 800
    data = init_tppr_state(M, n_nodes, K, "cpu").data
    if warm:
        head = [c[:warm] for c in cols]
        wplan = waves.plan_waves(*head[:3], head[5], n_nodes, CAP, "cpu")
        waves.wave_scan_reference(data, params,
                                  *_columns(data, *head)[:5], wplan)
    tail = [c[warm:] for c in cols]
    plan = waves.plan_waves(*tail[:3], tail[5], n_nodes, CAP, "cpu")
    return params, data, _columns(data, *tail), plan


@pytest.mark.parametrize("kind,n_seeds", [("random", 1), ("random", 3),
                                          ("dense", 1), ("dense", 2)])
def test_race_model_with_redirects_equals_the_plain_scan(kind, n_seeds):
    """With the redirect list, lanes run in reverse order with no barrier
    give the plain wave scan's bits: the table and the extraction rows."""
    params, start, cols, plan = _race_case(kind, n_seeds)
    assert len(plan.redirect)
    want = start.clone()
    want_rows = waves.wave_scan_reference(want, params, *cols[:5], plan)
    got = start.clone()
    got_rows = _race_model(got, params, cols, plan, plan.redirect)
    assert torch.equal(got, want) and torch.equal(got_rows, want_rows)


def test_race_model_without_redirects_differs_on_the_stress_stream():
    """The same model with an empty list reads the new rows of its wave's
    writers: the extraction rows differ, so the test above sees a missed
    pair."""
    params, start, cols, plan = _race_case("dense", 1)
    want = start.clone()
    want_rows = waves.wave_scan_reference(want, params, *cols[:5], plan)
    got = start.clone()
    got_rows = _race_model(got, params, cols, plan,
                           plan.redirect[:0])
    assert torch.equal(got, want)
    assert not torch.equal(got_rows, want_rows)


@pytest.mark.parametrize("m,k", [(1, 1), (2, 20), (3, 40), (4, 64)])
@pytest.mark.parametrize("n_neg", [1, 5, 50])
def test_geometry_covers_every_lane_once(m, k, n_neg):
    """Every lane of a wave of any width is taken exactly once by the
    cluster's slots over its passes; at most 16 blocks of at most 512
    threads; shared memory within 227 KB and exactly the lanes' rows and
    records."""
    f = row_width(m, k)
    for width in (1, 2, 15, 16, 17, 30, 63, 64, 65, 100, 256, 300):
        geom = wave_kernel.geometry(width, m, k, n_neg)
        assert 1 <= geom.cluster <= 16 and geom.lanes >= 1
        assert geom.lanes * 64 * m <= 512
        assert geom.smem_bytes == geom.lanes * 4 * (
            (2 + n_neg) * f + 2 * (8 + n_neg))
        assert geom.smem_bytes <= 227 * 1024
        lanes = wave_kernel.lane_schedule(geom, width)
        assert sorted(lanes[lanes >= 0].tolist()) == list(range(width))
        if width <= 64 and m <= 2 and n_neg <= 5:
            assert lanes.shape[0] == 1   # one pass: no lane loop
    assert wave_kernel.geometry(64, 2, 20, 1) == (16, 4, 4 * (3 * 648 + 72))


@pytest.mark.parametrize("m,k", [(5, 20), (2, 65), (0, 20), (2, 0)])
def test_geometry_refuses_members_and_k_past_its_limits(m, k):
    with pytest.raises(ValueError, match="k ≤ 64"):
        wave_kernel.geometry(64, m, k, 1)


def test_geometry_refuses_negatives_past_shared_memory():
    """A lane holds its 2 + S rows in shared memory: at (M, k) = (4, 64)
    that is at most 54 negatives."""
    assert wave_kernel.geometry(64, 4, 64, 54).lanes == 1
    with pytest.raises(ValueError, match="shared memory"):
        wave_kernel.geometry(64, 4, 64, 55)


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
    assert tuple(plan.redirect.shape) == (0, 4)
    assert plan.redirect_start.tolist() == [0]
    assert tuple(plan.redirect_mask.shape) == (0, 1)


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
    elif what == "redirect dtype":
        plan = plan._replace(redirect=plan.redirect.long())
    elif what == "redirect missing":
        plan = plan._replace(redirect=None)
    elif what == "redirect_start length":
        plan = plan._replace(redirect_start=plan.redirect_start[:-1])
    elif what == "redirect_mask shape":
        plan = plan._replace(redirect_mask=plan.redirect_mask.view(-1))
    return data, params, cols, plan, ext


@pytest.mark.parametrize("what", [
    "data dtype", "data width", "data strides", "src dtype", "dst length",
    "neg strides", "ts dtype", "valid dtype", "order dtype", "bounds length",
    "plan events", "ext width", "ext strides", "R", "redirect dtype",
    "redirect missing", "redirect_start length", "redirect_mask shape"])
def test_wrapper_refuses_bad_arguments(what):
    before = wave_kernel.SANTA_WAVES.launches
    with pytest.raises(ValueError):
        _call(*_bad(what))
    assert wave_kernel.SANTA_WAVES.launches == before


@pytest.mark.parametrize("extra_waves,parts,dtype", [
    (1, 4, torch.int64), (0, 5, torch.int64), (0, 4, torch.int32)])
def test_wrapper_refuses_a_bad_trace(extra_waves, parts, dtype):
    data, params, cols, plan, ext = _kernel_args()
    trace = torch.zeros((plan.n_waves + extra_waves, parts), dtype=dtype)
    before = wave_kernel.SANTA_WAVES.launches
    with pytest.raises(ValueError, match="trace"):
        wave_kernel.SANTA_WAVES(data, params, *cols, plan, ext, trace=trace)
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
