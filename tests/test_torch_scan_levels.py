"""The levels of the chunk scan's kernel (zebra_tpu_torch/index/scan.py:
``scan_levels``, ``geometry``; csrc/santa_scan.cu) and a plain model of the
kernel's order: the levels run one after another and the events of a level
in reverse stream order (a level's events are independent, so any order
must do), each through ``merge_both_reference``. The model equals
``scan_reference`` bit for bit, and the JAX package's ``streaming_scan`` /
``fill_scan`` at the merge bar (``assert_entries_close``: identical entry
sets, weights within 1e-5 relative, as tests/test_pallas_merge.py holds the
Pallas kernel and tests/test_torch_scan.py the plain scan); with the
write-after-read dependencies dropped it differs. The kernel runs only on
the card, where chip_smoke.py holds its levels equal to ``scan_levels`` and
its table and extraction rows bit-equal to ``scan_reference``.

Streams: 200-event chunks of the bench stream (``profile_serve.flagship``'s
``synthetic_stream(120_000, 20_000, 20_000, seed=0)``) with random
negatives, ``chip_smoke.scan_stream``'s dense 301-node stress chunk
(self-loops, invalid events, rows shared with the previous event), the
same with negatives equal to the event's own src or dst, and chunks longer
than one tile."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from zebra_tpu.index import streaming as jst
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index import scan
from zebra_tpu_torch.index.wave_kernel import MAX_SMEM
from zebra_tpu_torch.index.merge import merge_both_reference
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    _columns,
    fill_scan,
    init_tppr_state,
    unpack_queries,
)

BENCH_WARM, CHUNK = 1_000, 200
BENCH_CHUNKS = 20
M, K = 2, 20


@functools.lru_cache(maxsize=None)
def _bench_stream():
    """The bench stream's columns, random negatives, and the index after a
    plain fill of its first BENCH_WARM events (CPU)."""
    data, _ = synthetic_stream(120_000, 20_000, 20_000, seed=0)
    n_nodes = int(max(data.sources.max(), data.destinations.max())) + 1
    neg = np.random.RandomState(0).randint(0, n_nodes, len(data.sources))
    cols = (data.sources, data.destinations, neg.astype(np.int32),
            data.timestamps.astype(np.float32), data.edge_idxs,
            np.ones(len(neg), bool))
    params = TpprParams.create((0.1, 0.1), (0.05, 0.95), K)
    state = fill_scan(init_tppr_state(M, n_nodes, K, device="cpu"), params,
                      *(c[:BENCH_WARM] for c in (cols[0], cols[1], cols[3],
                                                 cols[4], cols[5])))
    return params, state.data, cols


def _bench_chunk(lo: int, n: int = CHUNK):
    params, data, cols = _bench_stream()
    return params, data, _columns(data, *(c[lo: lo + n] for c in cols))


@functools.lru_cache(maxsize=None)
def _stress_chunk():
    """``chip_smoke.scan_stream``'s stress chunk, as its scan phase makes it
    (200 events at (M, k) = (2, 20), seed 220)."""
    return chip_smoke.scan_stream(CHUNK, M, K, seed=CHUNK + K, device="cpu")


def _own_neg_chunk():
    """The stress chunk with every 4th negative the event's own src and
    every 5th its own dst (self-loops and invalid events stay)."""
    params, data, cols = _stress_chunk()
    src, dst, neg = (c.clone() for c in cols[:3])
    neg[1::4], neg[2::5] = src[1::4], dst[2::5]
    return params, data, (src, dst, neg) + tuple(cols[3:])


CHUNKS = {
    "bench": lambda: _bench_chunk(BENCH_WARM),
    "stress": _stress_chunk,
    "own_neg": _own_neg_chunk,
}


def _levels_without_war(src, dst, neg, valid, extract):
    """``scan_levels`` with the write-after-read dependencies dropped (one
    tile): only the last write of each row an event touches counts."""
    s, d, n = (c.tolist() for c in (src, dst, neg))
    v = valid.tolist()
    wrote, levels = {}, np.full(len(s), -1, np.int64)
    for e in range(len(s)):
        if not (extract or v[e]):
            continue
        rows = (s[e], d[e], n[e]) if extract else (s[e], d[e])
        up = max(wrote.get(r, 0) for r in rows) + 1
        if v[e]:
            wrote[s[e]] = wrote[d[e]] = up
        levels[e] = up - 1
    return levels


def _level_model(data, params, cols, levels, extract):
    """Run the levels in order and the events of a level in reverse order,
    each event's rows gathered from ``data``, merged and, when valid,
    written back (a self-loop writes its one row twice, with the same
    values). Updates ``data``; returns the pre-edge rows [E, 3, F] when
    ``extract``."""
    src, dst, neg, ts, eidx, valid = cols
    f = data.shape[1]
    ids = torch.stack((src, dst, neg), 1).long()
    rows = torch.zeros((len(src), 3, f))
    for lv in range(int(levels.max()) + 1):
        for e in np.flatnonzero(levels == lv)[::-1]:
            j = slice(e, e + 1)
            rows[j] = data[ids[j]]
            if valid[e]:
                new = merge_both_reference(rows[j], src[j], dst[j], eidx[j],
                                           ts[j], params)
                data[ids[e, :2]] = new.reshape(2, f)
    return rows if extract else None


def _reference(data, params, cols, extract):
    got = data.clone()
    return got, scan.scan_reference(got, params, *cols, extract=extract)


@pytest.mark.parametrize("extract", [True, False])
@pytest.mark.parametrize("chunk", sorted(CHUNKS))
def test_level_model_equals_scan_reference(chunk, extract):
    params, data, cols = CHUNKS[chunk]()
    want, want_rows = _reference(data, params, cols, extract)
    levels = scan.scan_levels(*cols[:3], cols[5], extract)
    got = data.clone()
    rows = _level_model(got, params, cols, levels, extract)
    assert torch.equal(got, want)
    if extract:
        assert torch.equal(rows, want_rows)
    assert not torch.equal(want, data)  # the chunk writes


def _as_fields(q):
    return np.stack([np.asarray(q.w), np.asarray(q.nbr, np.float32),
                     np.asarray(q.eidx, np.float32), np.asarray(q.dt)],
                    axis=-2)


def _split(rows, m, k):
    rows = np.asarray(rows)
    return rows[:, : 4 * m * k].reshape(-1, m, 4, k), rows[:, 4 * m * k:]


@pytest.mark.parametrize("chunk,extract", [("stress", True),
                                           ("stress", False),
                                           ("bench", True)])
def test_level_model_matches_jax(chunk, extract):
    """The model against JAX's ``streaming_scan`` (extracting) or
    ``fill_scan`` from the same index, on the table and the queries."""
    params, data, cols = CHUNKS[chunk]()
    m, k = len(params.alpha), params.k
    levels = scan.scan_levels(*cols[:3], cols[5], extract)
    got = data.clone()
    rows = _level_model(got, params, cols, levels, extract)
    j_params = jst.TpprParams.create(params.alpha, params.beta, k)
    j_state = jst.TpprState(data=jnp.asarray(data.numpy()))
    j_cols = [jnp.asarray(c.numpy()) for c in cols]
    if extract:
        j_state, j_q = jst.streaming_scan(j_state, j_params, *j_cols)
        q = unpack_queries(rows, cols[3], m, k)
        zeros = np.zeros(q.w.shape[:-1], np.float32)
        assert_entries_close(_as_fields(q), zeros, _as_fields(j_q), zeros)
    else:
        j_state = jst.fill_scan(j_state, j_params, j_cols[0], j_cols[1],
                                *j_cols[3:])
    assert_entries_close(*_split(got.numpy(), m, k),
                         *_split(j_state.data, m, k))


def test_model_without_write_after_read_differs_on_the_stress_chunk():
    """Teeth: levels that keep only the read-after-write dependencies put a
    write beside (or before) an earlier read of its row as a negative, and
    the model's order then reads the new row."""
    params, data, cols = _stress_chunk()
    levels = _levels_without_war(*cols[:3], cols[5], True)
    assert not np.array_equal(levels, scan.scan_levels(*cols[:3], cols[5]))
    want, want_rows = _reference(data, params, cols, True)
    got = data.clone()
    rows = _level_model(got, params, cols, levels, True)
    assert not torch.equal(rows, want_rows)


def _dependent(cols, extract):
    """[E, E] bool: event j (column) must run after event i (row), i < j:
    i writes a row j reads or writes, or j writes a row i reads."""
    src, dst, neg, _, _, valid = (np.asarray(c) for c in cols)
    reads = np.stack([src, dst, neg] if extract else [src, dst], 1)
    writes = np.where(valid[:, None], np.stack([src, dst], 1), -1)
    meet = lambda a, b: (a[:, None, :, None] == b[None, :, None, :]).any(
        (2, 3))
    dep = meet(writes, reads) | meet(reads, writes)
    live = valid | extract
    return np.triu(dep & live[:, None] & live[None, :], 1)


@pytest.mark.parametrize("extract", [True, False])
@pytest.mark.parametrize("chunk", sorted(CHUNKS))
def test_levels_are_the_longest_dependency_chains(chunk, extract):
    """Every level lies above each dependency's level, and each level above
    0 has a dependency one below it: the level is the longest chain of
    dependencies that ends at the event. Invalid events without extraction
    get -1."""
    _, _, cols = CHUNKS[chunk]()
    levels = scan.scan_levels(*cols[:3], cols[5], extract)
    valid = cols[5].numpy()
    live = valid | extract
    assert (levels[~live] == -1).all() and (levels[live] >= 0).all()
    dep = _dependent(cols, extract)
    i, j = np.nonzero(dep)
    assert (levels[j] > levels[i]).all()
    below = np.zeros_like(dep)
    below[i, j] = levels[i] == levels[j] - 1
    assert (below.any(0) | (levels <= 0))[live].all()


@pytest.mark.parametrize("extract", [True, False])
def test_bench_chunks_have_three_to_seven_levels(extract):
    """An observe chunk of the bench stream is a few levels of independent
    events: 3-7 levels per 200 events, with or without random negatives."""
    depths = []
    for c in range(BENCH_CHUNKS):
        _, _, cols = _bench_chunk(BENCH_WARM + c * CHUNK)
        depths.append(int(scan.scan_levels(*cols[:3], cols[5],
                                           extract).max()) + 1)
    assert 3 <= min(depths) and max(depths) <= 7, depths


@pytest.mark.parametrize("extract", [True, False])
def test_tiles_number_their_levels_after_the_previous_tile(extract):
    """At 64 events per tile the stress chunk is four tiles; each tile's
    levels lie above every level of the tiles before it, and the model in
    that order equals the plain scan."""
    params, data, cols = _stress_chunk()
    tile = 64
    levels = scan.scan_levels(*cols[:3], cols[5], extract, tile=tile)
    runs = [levels[lo: lo + tile] for lo in range(0, len(levels), tile)]
    for a, b in zip(runs, runs[1:]):
        assert b[b >= 0].min() == a.max() + 1
    want, want_rows = _reference(data, params, cols, extract)
    got = data.clone()
    rows = _level_model(got, params, cols, levels, extract)
    assert torch.equal(got, want)
    if extract:
        assert torch.equal(rows, want_rows)


def test_a_chunk_longer_than_one_tile():
    """2,100 bench events at the kernel's tile of 2,000 events: two tiles,
    the second's levels after the first's; the model equals the plain scan
    with extraction."""
    params, data, cols = _bench_chunk(BENCH_WARM, scan.MAX_TILE + 100)
    levels = scan.scan_levels(*cols[:3], cols[5])
    first, second = levels[: scan.MAX_TILE], levels[scan.MAX_TILE:]
    assert second.min() == first.max() + 1
    want, want_rows = _reference(data, params, cols, True)
    got = data.clone()
    rows = _level_model(got, params, cols, levels, True)
    assert torch.equal(got, want) and torch.equal(rows, want_rows)


@pytest.mark.parametrize("n,want", [
    (1, (1, 1, 1, 4)),
    (5, (5, 1, 5, 32)),
    (200, (16, 4, 200, 1024)),
    (2_048, (16, 4, 2_000, 8192)),
    (120_000, (16, 4, 2_000, 8192)),
])
def test_geometry_of_the_chunks_the_port_scans(n, want):
    """A 1-event observe takes one block of one lane, a 200-event chunk 16
    blocks of 4 lanes (M = 2), a fill tiles of 2,000 events."""
    geom = scan.geometry(n, M, K)
    assert tuple(geom[:4]) == want
    assert geom.smem_bytes == scan.smem_bytes(want[1], scan.row_width(M, K),
                                              want[2], want[3])


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_geometry_fits_the_block_at_every_width(m):
    for k in (1, 20, 31, 32, 40, 64):
        for n in (1, 3, 17, 200, 2_001, 120_000):
            geom = scan.geometry(n, m, k)
            assert 1 <= geom.cluster <= min(scan.MAX_CLUSTER, n)
            assert geom.lanes * 64 * m <= scan.MAX_THREADS
            assert 1 <= geom.tile <= min(n, scan.MAX_TILE)
            assert geom.hash >= 4 * geom.tile
            assert geom.hash & (geom.hash - 1) == 0
            assert geom.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("m,k", [(5, 20), (2, 65), (0, 20)])
def test_geometry_refuses_members_and_k_past_its_limits(m, k):
    with pytest.raises(ValueError):
        scan.geometry(200, m, k)


def _kernel_args(n=4, m=1, k=2):
    """CPU tensors of the kernel's argument shapes (never launched)."""
    one = lambda dt: torch.zeros(n, dtype=dt)
    return dict(data=torch.zeros((6, scan.row_width(m, k))),
                params=TpprParams.create((0.1,) * m, (0.9,) * m, k),
                src=one(torch.int32), dst=one(torch.int32),
                neg=one(torch.int32), e_ts=one(torch.float32),
                e_idx=one(torch.int32), valid=one(torch.bool))


@pytest.mark.parametrize("change", [
    dict(levels=torch.zeros(4, dtype=torch.int64)),
    dict(levels=torch.zeros(5, dtype=torch.int32)),
    dict(trace=torch.zeros((4, 5), dtype=torch.int64)),
    dict(trace=torch.zeros((5, 4), dtype=torch.int64)),
    dict(trace=torch.zeros((5, 5), dtype=torch.int32)),
], ids=["levels_dtype", "levels_shape", "trace_rows", "trace_parts",
        "trace_dtype"])
def test_wrapper_refuses_bad_levels_and_trace(change):
    args = {**_kernel_args(), **change}
    with pytest.raises(ValueError, match="levels|trace"):
        scan.SANTA_SCAN(args.pop("data"), args.pop("params"), **args)
    assert scan.SANTA_SCAN._fn is None
