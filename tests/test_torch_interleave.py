"""Owner-aligned waves and the node-id interleave of the row-sharded layout
(``--owner_aligned_waves``, ``--interleave_node_ids``,
``Config.interleave_shards``) against the JAX package: the port's copy of
``interleave_permutation``, its aligned scheduler
(``zebra_tpu_torch/csrc/wave_schedule.cc``) against
``zebra_tpu.native.ingest.wave_schedule(..., n_shards)``, the wave
inflation the interleave removes (tests/test_interleave.py:32-61), a
two-rank interleaved Trainer against a plain one (CPU ranks,
tests/torch_rank_worker.py), serving an interleaved state file on external
ids, and the auto rule of ``resolve_owner_aligned``.

Bars: the permutation and the schedules equal JAX's, slot for slot; the
interleaved run's AP within JAX's 5e-3 of the plain run's
(tests/test_interleave.py:73-97), its index mapped back through the
inverse permutation bit-equal to the plain run's at these sizes (ties in
the top-k break by neighbor id, so a relabelling may reorder equal
weights: not seen here); served external ids score within 5e-3 of the
plain file's."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.torch_rank_worker import SMALL, run_group, splits
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.native.ingest import wave_schedule as jax_wave_schedule
from zebra_tpu.parallel import interleave_permutation as jax_permutation
from zebra_tpu.serve import _events_to_internal as jax_events_to_internal
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index.waves import wave_schedule
from zebra_tpu_torch.parallel.sharding import (
    interleave_inverse,
    interleave_permutation,
)
from zebra_tpu_torch.serve import LinkPredictor, events_to_internal
from zebra_tpu_torch.train.loop import resolve_owner_aligned

AP_ATOL = SCORE_ATOL = 5e-3


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    return run_group(["rows_aligned"],
                     tmp_path_factory.mktemp("aligned"))["rows_aligned"]


@pytest.mark.parametrize("n,s", [(128, 2), (256, 4), (1024, 8), (640, 5)])
def test_permutation_equals_jax(n, s):
    p = interleave_permutation(n, s)
    np.testing.assert_array_equal(p, jax_permutation(n, s))
    assert p[0] == 0 and sorted(p.tolist()) == list(range(n))
    inv = interleave_inverse(n, s)
    np.testing.assert_array_equal(inv[p], np.arange(n))
    np.testing.assert_array_equal(p[inv], np.arange(n))
    # old id i lands in shard i % s under contiguous-row ownership
    np.testing.assert_array_equal(p // (n // s), np.arange(n) % s)


def test_permutation_refuses_a_count_that_does_not_divide():
    with pytest.raises(ValueError, match="multiple"):
        interleave_permutation(130, 4)


def _stream(bipartite: bool, n: int = 3000, seed: int = 0):
    rs = np.random.RandomState(seed)
    if bipartite:
        data, _ = synthetic_stream(n_events=n, n_users=300, n_items=300,
                                   edge_dim=0, seed=seed)
        src, dst = (c.astype(np.int32) for c in (data.sources,
                                                 data.destinations))
    else:
        src, dst = (rs.randint(1, 600, n).astype(np.int32) for _ in "ab")
    n_raw = int(max(src.max(), dst.max())) + 1
    neg = rs.randint(1, n_raw, n).astype(np.int32)
    return src, dst, neg, -(-n_raw // 128) * 128


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("bipartite", [False, True],
                         ids=["random", "bipartite"])
def test_aligned_schedule_equals_jax(bipartite, n_shards):
    src, dst, neg, n_nodes = _stream(bipartite)
    got = wave_schedule(src, dst, neg, n_nodes, 64, n_shards)
    want = jax_wave_schedule(src, dst, neg, n_nodes, 64, n_shards)
    np.testing.assert_array_equal(got[0], want[0])     # wave
    np.testing.assert_array_equal(got[1], want[1])     # slot
    assert got[2] == want[2]
    # slot s of a wave lies in the block of its source's owner
    rows = -(-n_nodes // n_shards)
    np.testing.assert_array_equal(got[1] // (64 // n_shards), src // rows)


def test_aligned_schedule_refuses_cap_not_a_multiple():
    src, dst, neg, n_nodes = _stream(False, n=50)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        jax_wave_schedule(src, dst, neg, n_nodes, 30, 4)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        wave_schedule(src, dst, neg, n_nodes, 30, 4)


def test_interleave_removes_bipartite_wave_inflation():
    """tests/test_interleave.py's claim on the port's scheduler: on a
    bipartite (JODIE-numbered) stream the aligned schedule at 2 shards
    inflates ≥ 1.5× without the interleave and stays within 1.25× of the
    unaligned count with it."""
    data, _ = synthetic_stream(n_events=20_000, n_users=2_000,
                               n_items=2_000, edge_dim=0, seed=0)
    src = data.sources.astype(np.int32)
    dst = data.destinations.astype(np.int32)
    n_raw = int(max(src.max(), dst.max())) + 1
    n_nodes = -(-n_raw // 128) * 128
    neg = np.random.RandomState(0).randint(1, n_raw, len(src)).astype(
        np.int32)
    _, _, w_base = wave_schedule(src, dst, neg, n_nodes, 64, 1)
    _, _, w_aligned = wave_schedule(src, dst, neg, n_nodes, 64, 2)
    assert w_aligned >= 1.5 * w_base, (w_base, w_aligned)
    perm = interleave_permutation(n_nodes, 2)
    _, _, w_perm = wave_schedule(perm[src], perm[dst], perm[neg], n_nodes,
                                 64, 2)
    assert w_perm <= 1.25 * w_base, (w_base, w_aligned, w_perm)


def test_trainers_resolve_the_layout(aligned):
    """On one host auto keeps the waves unaligned and the ids raw; aligned
    waves auto-interleave unless told not to."""
    for r in aligned:
        assert (r["plain"]["wave_shards"], r["plain"]["shards"]) == (1, 0)
        assert (r["aligned"]["wave_shards"], r["aligned"]["shards"]) == (2, 0)
        assert (r["interleaved"]["wave_shards"],
                r["interleaved"]["shards"]) == (2, 2)


@pytest.mark.parametrize("leg", ["aligned", "interleaved"])
def test_aligned_trainer_matches_plain(aligned, leg):
    for r in aligned:
        plain, got = r["plain"], r[leg]
        for f in ("train", "val", "nn_val"):
            assert abs(got[f] - plain[f]) <= AP_ATOL, (leg, f)


def test_interleaved_index_maps_back_to_the_plain_one(aligned):
    r = aligned[0]
    index, n = r["interleaved"]["index"], r["interleaved"]["index"].shape[0]
    m, k = len(SMALL["alpha_list"]), SMALL["topk"]
    perm = torch.from_numpy(interleave_permutation(n, 2).astype(np.int64))
    inv = torch.from_numpy(interleave_inverse(n, 2).astype(np.int64))
    rows = index[perm]
    fields = rows[:, : 4 * m * k].reshape(n, m, 4, k).clone()
    fields[:, :, 1] = inv[fields[:, :, 1].to(torch.int64)].to(torch.float32)
    back = torch.cat([fields.reshape(n, -1), rows[:, 4 * m * k:]], dim=1)
    assert torch.equal(back, r["plain"]["index"])
    assert torch.equal(r["aligned"]["index"], r["plain"]["index"])


def test_served_interleaved_file_answers_external_ids(aligned):
    """``from_checkpoint`` of the interleaved file rebuilds the permutation
    from ``interleave_shards`` and scores external ids as the plain file's
    predictor does, before and after an observe."""
    r = aligned[0]
    sp, ef = splits()
    te = sp.test
    q = (te.sources[:64], te.destinations[:64], te.timestamps[:64])
    plain = LinkPredictor.from_checkpoint(r["plain"]["path"], edge_feats=ef,
                                          device="cpu")
    inter = LinkPredictor.from_checkpoint(r["interleaved"]["path"],
                                          edge_feats=ef, device="cpu")
    assert inter.cfg.interleave_shards == 2 and inter._id_perm is not None
    np.testing.assert_allclose(inter.score(*q), plain.score(*q), rtol=0,
                               atol=SCORE_ATOL)
    obs = (te.sources[-8:], te.destinations[-8:], te.timestamps[-8:],
           te.edge_idxs[-8:])
    inter.observe(*obs)
    plain.observe(*obs)
    np.testing.assert_allclose(inter.score(*q), plain.score(*q), rtol=0,
                               atol=SCORE_ATOL)
    with pytest.raises(ValueError, match="node ids must lie"):
        inter.score([inter.cfg.n_nodes], [1], [1.0])


@pytest.mark.parametrize("shards", [0, 2, 4])
def test_events_map_as_jax_maps_them(shards):
    events = (np.array([1, 5, 9, 127]), np.array([3, 0, 64, 2]),
              np.array([1.0, 2.0, 3.0, 4.0]), np.array([1, 2, 3, 4]))
    kw = dict(n_nodes=128, interleave_shards=shards)
    got = events_to_internal(Config(**kw), events)
    want = jax_events_to_internal(JaxConfig(**kw), events)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flag,hosts,want", [
    (None, 1, False), (None, 2, True), (True, 1, True), (False, 3, False)])
def test_resolve_owner_aligned(flag, hosts, want):
    """Auto is on where the ranks span more than one host (a one-host JAX
    mesh is one process, whose auto is off); the flag wins."""
    cfg = Config(owner_aligned_waves=flag)
    assert resolve_owner_aligned(cfg, hosts) is want
