"""The plain reference against the port's CPU path at a tiny size (a test
may call the port; the reference never does)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import harness

from benchmark import streams
from benchmark.loops import serve, train
from benchmark.reference import bfs, santa
from benchmark.reference.model import Prec


def _stream(n=1500, seed=4):
    ev = streams.synthetic_events(n, 60, 25, seed)
    return ev.src, ev.dst, ev.t.astype(np.float32), ev.eidx


@pytest.mark.parametrize("m,k", [(1, 5), (2, 20)])
def test_santa_matches_the_port(m, k):
    from zebra_tpu_torch.index.layout import TpprParams
    from zebra_tpu_torch.index.streaming import init_tppr_state, streaming_scan

    alpha, beta = (0.1, 0.2)[:m], (0.5, 0.95)[:m]
    src, dst, t, e = _stream()
    neg = np.roll(dst, 7)
    n = int(max(src.max(), dst.max())) + 1
    state = init_tppr_state(m, n, k, device="cpu")
    state, q = streaming_scan(state, TpprParams.create(alpha, beta, k), src,
                              dst, neg, t, e, np.ones(len(src), bool))
    ref = santa.Index(n, alpha, beta, k)
    ext = ref.scan(src, dst, t, e, neg[None], extract=True)
    got = santa.Index.from_packed(state.data.numpy(), alpha, beta, k)
    assert santa.gap(ref, got) == 0.0
    # the extraction, [E, M, 3, k] in the port, [E, 3, M, k] here
    np.testing.assert_array_equal(q.nbr.numpy().transpose(0, 2, 1, 3),
                                  ext["nbr"])
    np.testing.assert_array_equal(q.w.numpy().transpose(0, 2, 1, 3),
                                  ext["w"])


def test_santa_control_differs():
    src, dst, t, e = _stream()
    n = int(max(src.max(), dst.max())) + 1
    ref = santa.Index(n, (0.1, 0.1), (0.5, 0.95), 20)
    low = santa.Index(n, (0.1, 0.1), (0.5, 0.95), 20, low=True)
    ref.scan(src, dst, t, e)
    low.scan(src, dst, t, e)
    assert santa.gap(ref, low) > 1e-4


@pytest.mark.parametrize("width,depth", [(4, 2), (10, 2), (3, 3)])
def test_bfs_matches_the_port(width, depth):
    from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
    from zebra_tpu_torch.index.pruning import pruned_topk

    src, dst, t, e = _stream(1200, 9)
    n = int(max(src.max(), dst.max())) + 1
    alpha, beta = (0.1, 0.1), (0.5, 0.95)
    idx = build_neighbor_index(src, dst, t.astype(np.float64), e, n, "cpu")
    roots = np.concatenate([src[600:700], dst[600:700]])
    times = np.concatenate([t[600:700], t[600:700]])
    q = pruned_topk(idx, torch.tensor(alpha), torch.tensor(beta),
                    torch.as_tensor(roots), torch.as_tensor(times), width,
                    depth, 20)
    adj = bfs.Adjacency(src, dst, t.astype(np.float64), e, n)
    ref = bfs.pruned_topk(adj, alpha, beta, roots, times, width, depth, 20)
    got = dict(w=q.w.numpy(), nbr=q.nbr.numpy(), eidx=q.eidx.numpy())
    assert bfs.gap(ref, got) < 1e-6
    same = ((ref["w"] > 0) & (ref["nbr"] == got["nbr"])
            & (ref["eidx"] == got["eidx"]))
    assert same.mean() > 0.5 * (ref["w"] > 0).mean()
    np.testing.assert_allclose(q.dt.numpy()[same], ref["dt"][same], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("workload", [
    "wikipedia.train", "mooc-pruning.train", "wikipedia.train-s5"])
def test_train_steps_match_the_port(tiny, workload):
    h = harness(tiny, workload)
    st = train.setup(h)
    ref = train.reference(st, Prec(), h.ref_device)
    nums = train.numbers(train.program_side(st), ref)
    assert max(nums.values()) < 1e-5, nums
    low = train.reference(st, Prec(low=True), h.ref_device)
    ctrl = train.numbers(dict(lanes=low["lanes"], **{
        k: low[k] for k in ("index", "bfs") if k in low}), ref)
    assert ctrl["loss_gap"] > 1e-5 and ctrl["memory_gap"] > 1e-3, ctrl


def test_serve_steps_match_the_port(tiny):
    h = harness(tiny, "wikipedia.serve")
    st = serve.setup(h)
    serve.window(h, st, 0.5)
    nums = serve.numbers(st, h.ref_device)
    assert max(nums.values()) < 1e-6, nums
    ctrl = serve.numbers(st, h.ref_device, control=True)
    assert min(ctrl.values()) > 1e-4, ctrl
