"""The port's chunk scan (zebra_tpu_torch/index/scan.py) and ``fill_scan``:
against JAX ``fill_scan``, the plain scan against ``streaming_scan``, the
serving ``observe`` against ``streaming_scan``, and the ``santa_scan``
wrapper's refusals (the kernel itself runs only on the card, in
chip_smoke.py).

JAX states are held to the merge bar of test_torch_merge.py (XLA may
contract an FMA inside its fused scan); port against port is bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from tests.test_torch_streaming import ALPHA, BETA, K, M, N_NODES, _fields, _stream
from zebra_tpu.index import streaming as jst
from zebra_tpu_torch.index import scan as psc
from zebra_tpu_torch.index import streaming as pst
from zebra_tpu_torch.index.layout import row_width

PARAMS = pst.TpprParams.create(ALPHA, BETA, K)


def _dense_stream(n_edges=240, seed=5):
    """A stream on few nodes where consecutive events share nodes: every
    fifth neg is the previous event's src, every sixth the previous dst,
    with self-loops and invalid events."""
    src, dst, neg, ts, eidx, valid = _stream(n_edges, seed)
    rng = np.random.RandomState(seed)
    src, dst = (rng.randint(1, 8, n_edges).astype(np.int32) for _ in range(2))
    dst[::9] = src[::9]
    neg[1::5] = src[:-1:5][: len(neg[1::5])]
    neg[1::6] = dst[:-1:6][: len(neg[1::6])]
    src[2::7] = dst[1:-1:7][: len(src[2::7])]     # src repeats the last dst
    return src, dst, neg, ts, eidx, valid


def _cols(cols):
    return pst._columns(pst.init_tppr_state(M, N_NODES, K, device="cpu").data,
                        *cols)


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_scan_matches_jax(seed):
    src, dst, _, ts, eidx, valid = _stream(seed=seed)
    j_state = jst.fill_scan(
        jst.init_tppr_state(M, N_NODES, K), jst.TpprParams.create(ALPHA, BETA, K),
        *(jnp.asarray(c) for c in (src, dst, ts, eidx, valid)))
    p_state = pst.fill_scan(pst.init_tppr_state(M, N_NODES, K, device="cpu"),
                            PARAMS, src, dst, ts, eidx, valid)
    assert_entries_close(*_fields(p_state.data.numpy()),
                         *_fields(j_state.data))


@pytest.mark.parametrize("stream", [_stream, _dense_stream])
def test_scan_reference_equals_streaming_scan(stream):
    """The plain scan, called directly, equals ``streaming_scan`` on the CPU
    bit for bit, in the state and in the extraction rows; without
    extraction it leaves the same state."""
    cols = stream()
    state = pst.init_tppr_state(M, N_NODES, K, device="cpu")
    state, q = pst.streaming_scan(state, PARAMS, *cols)

    data = pst.init_tppr_state(M, N_NODES, K, device="cpu").data
    rows = psc.scan_reference(data, PARAMS, *_cols(cols))
    torch.testing.assert_close(data, state.data, rtol=0, atol=0)
    want = pst.unpack_queries(rows, torch.from_numpy(cols[3]), M, K)
    for a, b in zip(q, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    no_ext = pst.init_tppr_state(M, N_NODES, K, device="cpu").data
    assert psc.scan_reference(no_ext, PARAMS, *_cols(cols),
                              extract=False) is None
    torch.testing.assert_close(no_ext, state.data, rtol=0, atol=0)


def test_dense_stream_has_the_hard_cases():
    src, dst, neg, _, _, valid = _dense_stream()
    assert (src == dst).any() and (~valid).any()
    assert (neg[1:] == src[:-1]).any() and (neg[1:] == dst[:-1]).any()
    assert (src[1:] == dst[:-1]).any()


def test_fill_scan_equals_streaming_scan_state():
    """neg is read only for extraction, so fill_scan (neg = src) leaves the
    same index as streaming_scan with neg = dst."""
    src, dst, _, ts, eidx, valid = _dense_stream()
    a = pst.fill_scan(pst.init_tppr_state(M, N_NODES, K, device="cpu"),
                      PARAMS, src, dst, ts, eidx, valid)
    b, _ = pst.streaming_scan(pst.init_tppr_state(M, N_NODES, K, device="cpu"),
                              PARAMS, src, dst, dst, ts, eidx, valid)
    torch.testing.assert_close(a.data, b.data, rtol=0, atol=0)


def test_observe_leaves_the_streaming_scan_index():
    from tests.test_torch_serve import B, _pair

    data, _, port = _pair("float32")
    before = port.index_state.data.clone()
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs)
    for lo in range(0, 2 * B, B):
        port.observe(*(c[lo: lo + B] for c in cols))
    m, k = port.cfg.n_tppr, port.cfg.topk
    want = pst.TpprState(before)
    n = 2 * B
    want, _ = pst.streaming_scan(want, pst.TpprParams.create(
        port.cfg.alpha_list, port.cfg.beta_list, k), cols[0][:n], cols[1][:n],
        cols[1][:n], cols[2][:n], cols[3][:n], np.ones(n, bool))
    assert want.data.shape[1] == row_width(m, k)
    torch.testing.assert_close(port.index_state.data, want.data, rtol=0,
                               atol=0)


@pytest.mark.parametrize("bad", [N_NODES, -1, 2**32 + 1])
def test_node_ids_out_of_range_raise(bad):
    """Ids are checked as given: 2^32 + 1 would wrap to 1 in i32."""
    src, dst, neg, ts, eidx, valid = _stream(10)
    dst = dst.astype(np.int64)
    dst[3] = bad
    with pytest.raises(ValueError, match="node ids"):
        pst.fill_scan(pst.init_tppr_state(M, N_NODES, K, device="cpu"),
                      PARAMS, src, dst, ts, eidx, valid)


def test_wide_edge_ids_raise():
    src, dst, neg, ts, eidx, valid = _stream(10)
    eidx = eidx.astype(np.int64)
    eidx[3] = 2**32 + 1
    with pytest.raises(ValueError, match="2\\^24"):
        pst.fill_scan(pst.init_tppr_state(M, N_NODES, K, device="cpu"),
                      PARAMS, src, dst, ts, eidx, valid)


def _kernel_args(n=4, m=1, k=2):
    """CPU tensors of the kernel's argument shapes (never launched)."""
    one = lambda dt: torch.zeros(n, dtype=dt)
    data = torch.zeros((6, row_width(m, k)))
    params = pst.TpprParams.create((0.1,) * m, (0.9,) * m, k)
    return dict(data=data, params=params, src=one(torch.int32),
                dst=one(torch.int32), neg=one(torch.int32),
                e_ts=one(torch.float32), e_idx=one(torch.int32),
                valid=one(torch.bool),
                ext=torch.zeros((n, 3, row_width(m, k))))


@pytest.mark.parametrize("change,match", [
    (dict(params=pst.TpprParams.create((0.1,) * 5, (0.9,) * 5, 2)), "M ≤"),
    (dict(params=pst.TpprParams.create((0.1,), (0.9,), 65)), "k ≤"),
    (dict(src=torch.zeros(4, dtype=torch.int64)), "src must be"),
    (dict(e_ts=torch.zeros(4, dtype=torch.float64)), "e_ts must be"),
    (dict(valid=torch.zeros(4, dtype=torch.uint8)), "valid must be"),
    (dict(data=torch.zeros((9, 6)).t()), "data must be"),
    (dict(data=torch.zeros((6, 9), dtype=torch.float64)), "data must be"),
    (dict(ext=torch.zeros((4, 2, 9))), "ext must be"),
    (dict(ext=torch.zeros((4, 9, 3)).transpose(1, 2)), "ext must be"),
], ids=["m", "k", "src_dtype", "ts_dtype", "valid_dtype", "data_strides",
        "data_dtype", "ext_shape", "ext_strides"])
def test_scan_wrapper_checks_before_building(change, match):
    """The santa_scan wrapper raises ValueError before any build."""
    args = {**_kernel_args(), **change}
    params = args.pop("params")
    with pytest.raises(ValueError, match=match):
        psc.SANTA_SCAN(args.pop("data"), params, **args)
    assert psc.SANTA_SCAN.launches == 0 and psc.SANTA_SCAN._fn is None


def test_scan_wrapper_refuses_cpu_tensors():
    args = _kernel_args()
    with pytest.raises(ValueError, match="cuda tensors"):
        psc.SANTA_SCAN(args.pop("data"), args.pop("params"), **args)
    assert psc.SANTA_SCAN._fn is None


@pytest.mark.parametrize("extract", [True, False])
def test_scan_refuses_other_devices(extract):
    args = _kernel_args()
    meta = {name: t.to("meta") for name, t in args.items()
            if isinstance(t, torch.Tensor) and name != "ext"}
    with pytest.raises(ValueError, match="cpu or cuda"):
        psc.scan(meta.pop("data"), args["params"], meta["src"], meta["dst"],
                 meta["neg"], meta["e_ts"], meta["e_idx"], meta["valid"],
                 extract)
