"""The port's plain SANTA merge (zebra_tpu_torch/index/merge.py) against the
JAX merge ``_merge_both`` and the Pallas kernel in interpret mode, on the
same realistic gathered rows.

The bar is the one ``test_pallas_merge.py`` holds the Pallas kernel to:
identical entry sets except where a weight sits within rounding of the
k-th cut, weights within 1e-5 relative, timestamps exact (they are copied),
norms within 1e-6 relative. XLA may contract a multiply and an add into one
FMA where eager torch rounds twice, which is the only source of a gap."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.index.pallas_merge import merge_both_pallas
from zebra_tpu.index.streaming import TpprParams as JaxTpprParams, _merge_both
from zebra_tpu_torch.index import merge as pm
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    init_tppr_state,
    pack_rows,
    row_width,
    split_rows,
    streaming_scan,
)

SHAPES = [(1, 5), (2, 10), (2, 20), (3, 40)]


@functools.lru_cache(maxsize=None)
def _rows(m, k, w=16, n_nodes=30):
    """Realistic gathered rows, as ``test_pallas_merge._random_state_rows``
    makes them: a 300-edge stream scanned (here by the port's plain scan),
    then the rows of ``w`` random (src, dst, neg) triples and fresh edges.
    Cached per shape; callers copy before editing."""
    rng = np.random.RandomState(m + k)
    e = 300
    src, dst, neg = (rng.randint(1, n_nodes, e).astype(np.int32)
                     for _ in range(3))
    ts = np.cumsum(rng.exponential(1.0, e)).astype(np.float32)
    eidx = np.arange(1, e + 1, dtype=np.int32)
    alpha, beta = (0.1, 0.2, 0.0)[:m], (0.9, 0.6, 0.5)[:m]
    state = init_tppr_state(m, n_nodes, k, device="cpu")
    state, _ = streaming_scan(state, TpprParams.create(alpha, beta, k), src,
                              dst, neg, ts, eidx, np.ones(e, bool))
    sdn = rng.randint(1, n_nodes, (w, 3)).astype(np.int32)
    fields, norm = split_rows(state.data[torch.from_numpy(sdn).long()], m, k)
    g_ts = (ts[-1] + 1 + rng.rand(w)).astype(np.float32)
    g_eidx = np.arange(e + 1, e + 1 + w, dtype=np.int32)
    return (JaxTpprParams.create(alpha, beta, k), fields.numpy(),
            norm[:, :2].numpy(), sdn[:, 0], sdn[:, 1], g_eidx, g_ts)


def assert_entries_close(got_f, got_n, want_f, want_n):
    """``test_pallas_merge.py:test_kernel_matches_xla_merge``'s bar on
    fields [..., M, 4, k] (w, nbr, eidx, ts) and norms [..., M]."""
    np.testing.assert_allclose(got_n, want_n, rtol=1e-6)
    m, k = got_f.shape[-3], got_f.shape[-1]
    gf, wf = got_f.reshape(-1, 4, k), want_f.reshape(-1, 4, k)
    for lane in range(gf.shape[0]):
        entries = lambda f: {
            (int(e), int(n)): (float(x), float(t))
            for x, n, e, t in zip(*f[lane]) if x > 0
        }
        g, w = entries(gf), entries(wf)
        cut = min(x for x, _ in w.values()) if w else 0.0
        for key in set(g) ^ set(w):
            x = (g.get(key) or w.get(key))[0]
            assert x == pytest.approx(cut, rel=1e-4), (lane, key)
        for key in set(g) & set(w):
            assert g[key][0] == pytest.approx(w[key][0], rel=1e-5), (lane, key)
            assert g[key][1] == w[key][1], (lane, key)


def _port_args(params, fields3, norm_sd, src, dst, eidx, ts):
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(fields3), t(norm_sd), t(src), t(dst), t(eidx), t(ts),
            TpprParams.create(params.alpha, params.beta, params.k))


def _jax_merge(params, fields3, norm_sd, src, dst, eidx, ts):
    f, n = jax.jit(jax.vmap(
        lambda f3, nsd, s, d, e, tt: _merge_both(f3, nsd, s, d, e, tt, params)
    ))(jnp.asarray(fields3), jnp.asarray(norm_sd), jnp.asarray(src),
      jnp.asarray(dst), jnp.asarray(eidx), jnp.asarray(ts))
    return np.asarray(f), np.asarray(n)


def _port_merge(*args):
    f, n = pm.merge_both_fields(*_port_args(*args))
    return f.numpy(), n.numpy()


@pytest.mark.parametrize("m,k", SHAPES)
def test_reference_matches_jax_merge(m, k):
    args = _rows(m, k)
    assert_entries_close(*_port_merge(*args), *_jax_merge(*args))


@pytest.mark.parametrize("m,k", SHAPES)
def test_reference_matches_pallas_interpret(m, k):
    args = _rows(m, k)
    params, fields3, norm_sd, src, dst, eidx, ts = args
    want_f, want_n = merge_both_pallas(
        jnp.asarray(fields3), jnp.asarray(norm_sd), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(eidx), jnp.asarray(ts), params,
        interpret=True,
    )
    assert_entries_close(*_port_merge(*args), np.asarray(want_f),
                         np.asarray(want_n))


def test_alpha_zero():
    """α = 0 gives the fresh entry the full merge scale (no α factor)."""
    params, *rest = _rows(2, 10)
    params = params._replace(alpha=(0.0, 0.0))
    args = (params, *rest)
    got_f, got_n = _port_merge(*args)
    assert_entries_close(got_f, got_n, *_jax_merge(*args))


def test_empty_rows():
    """From empty rows the only entry is the fresh one: weight (1-α)·α
    (1-α when α = 0) for the partner, norm β."""
    params, fields3, norm_sd, src, dst, eidx, ts = _rows(3, 40)
    fields3, norm_sd = np.zeros_like(fields3), np.zeros_like(norm_sd)
    args = (params, fields3, norm_sd, src, dst, eidx, ts)
    got_f, got_n = _port_merge(*args)
    assert_entries_close(got_f, got_n, *_jax_merge(*args))
    alpha = np.asarray(params.alpha, np.float32)
    one = np.float32(1.0)
    want_w = np.where(alpha != 0, (one - alpha) * alpha, one - alpha)
    np.testing.assert_array_equal(got_f[:, 0, :, 0, 0],
                                  np.broadcast_to(want_w, (16, 3)))
    np.testing.assert_array_equal(got_f[:, 0, :, 1, 0], dst[:, None] + 0 * alpha)
    np.testing.assert_array_equal(got_f[:, 1, :, 1, 0], src[:, None] + 0 * alpha)
    assert not got_f[:, :, :, :, 1:].any()
    np.testing.assert_array_equal(
        got_n, np.broadcast_to(np.asarray(params.beta, np.float32), (16, 2, 3)))


def test_self_loop_lanes():
    """src == dst: both directions read the same row twice and must produce
    the same new row (the scan's duplicate scatter relies on it)."""
    params, fields3, norm_sd, src, dst, eidx, ts = _rows(2, 10)
    fields3 = np.array(fields3)
    fields3[:, 1] = fields3[:, 0]
    norm_sd = np.array(norm_sd)
    norm_sd[:, 1] = norm_sd[:, 0]
    args = (params, fields3, norm_sd, src, src, eidx, ts)
    got_f, got_n = _port_merge(*args)
    np.testing.assert_array_equal(got_f[:, 0], got_f[:, 1])
    np.testing.assert_array_equal(got_n[:, 0], got_n[:, 1])
    assert_entries_close(got_f, got_n, *_jax_merge(*args))


def test_packed_rows_match_fields_view():
    """merge_both on packed rows [W, 3, F] (the scan's gather, neg row
    included and ignored) equals the [W, 2, M, 4, k] view."""
    m, k, w = 2, 20, 16
    args = _rows(m, k)
    f3, nsd, src, dst, eidx, ts, params = _port_args(*args)
    fields, norms = pm.merge_both_fields(f3, nsd, src, dst, eidx, ts, params)
    norm3 = torch.cat([nsd, torch.rand(w, 1, m)], dim=1)
    rows3 = pack_rows(f3, norm3).contiguous()
    assert rows3.shape == (w, 3, row_width(m, k))
    packed = pm.merge_both(rows3, src, dst, eidx, ts, params)
    assert packed.shape == (w, 2, row_width(m, k))
    torch.testing.assert_close(packed, pack_rows(fields, norms), rtol=0, atol=0)
    two_rows = pm.merge_both(rows3[:, :2].contiguous(), src, dst, eidx, ts,
                             params)
    torch.testing.assert_close(two_rows, packed, rtol=0, atol=0)


def test_kernel_wrapper_checks_limits_before_building():
    """k and M above the kernel's static limits raise before any build."""
    params = TpprParams.create((0.1,), (0.9,), pm.MAX_K + 1)
    rows = torch.zeros((1, 2, row_width(1, pm.MAX_K + 1)))
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k ≤"):
        pm.SANTA_MERGE(rows, one, one, one, one.float(), params)
    assert pm.SANTA_MERGE.launches == 0
