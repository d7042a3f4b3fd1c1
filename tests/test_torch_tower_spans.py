"""The recursive tower's spans (``models/embedding.py``) and the
benchmark's count of its work (``benchmark/loops/train_tower.py:Counts``).

Checks, on the CPU profiler at tiny sizes: a graph-attention train batch
records ``zebra.hops``, ``zebra.rows`` and ``zebra.attention`` inside its
``zebra.forward``, a diffusion batch none of them; the counts hold the hop
trees' shapes (3b roots, 3b·n + 3b·n² slots, their sum of rows) and, on the
device, the valid slots and the gathered rows with a pending message, each
equal to a plain count of the recorded trees and of the message flags
before the batch; a diffusion tower builds no tree to count."""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.loops import train_tower
from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.utils import profiling

BS, CHUNK, N = 50, 200, 3
TOWER = ["zebra.hops", "zebra.rows", "zebra.attention"]


def _trainer(tmp_path, **kw) -> Trainer:
    data, ef = synthetic_stream(n_events=600, n_users=20, n_items=20,
                                edge_dim=4, seed=0)
    cfg = Config(bs=BS, index_chunk=CHUNK, node_dim=8, time_dim=8,
                 memory_dim=8, topk=4, alpha_list=(0.1,), beta_list=(0.9,),
                 checkpoint_dir=str(tmp_path), **kw)
    return Trainer(cfg, split_data(data.sources, data.destinations,
                                   data.timestamps, data.edge_idxs,
                                   data.labels), ef, device="cpu")


def _attention(tmp_path, n_layer=2):
    return _trainer(tmp_path, embedding_module="graph_attention",
                    n_degree=N, n_layer=n_layer, n_head=2)


def _batch_spans(tr):
    """Per train batch of one superchunk under the profiler: the names of
    the spans inside its forward, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_epoch(max_chunks=1)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name in profiling.SPANS),
                   key=lambda x: (x[1], -x[2]))
    fwd = [s for s in spans if s[0] == "zebra.forward"]
    return [[n for n, a, b in spans if lo <= a and b <= hi and
             (n, a, b) != (name, lo, hi)] for name, lo, hi in fwd]


def test_recursive_batch_spans(tmp_path):
    inside = _batch_spans(_attention(tmp_path))
    assert inside
    for names in inside:
        assert names == TOWER


def test_diffusion_batch_has_no_tower_span(tmp_path):
    inside = _batch_spans(_trainer(tmp_path))
    assert inside
    for names in inside:
        assert not set(names) & set(TOWER)


@pytest.mark.parametrize("n_layer", [1, 2])
def test_counters_equal_a_plain_count(tmp_path, n_layer):
    import zebra_tpu_torch.train.phase as phase

    tr = _attention(tmp_path, n_layer)
    trees, flags = [], []
    orig_fwd = phase._train_forward

    def forward(cfg, params, mem, *a, **kw):
        flags.append(mem.messages[:, -1].clone() != 0)
        return orig_fwd(cfg, params, mem, *a, **kw)

    phase._train_forward = forward
    try:
        with train_tower.counting(tr, lambda i, t: trees.append(t)) as c:
            tr.train_epoch()
    finally:
        phase._train_forward = orig_fwd
    got = c.per_batch()
    n_b = len(trees)
    assert n_b == len(flags) == c.batches == tr.eager_batches > 1
    roots = 3 * BS
    slots = sum(roots * N ** (l + 1) for l in range(n_layer))
    assert (got["roots"], got["slots"], got["rows"]) == (
        roots, slots, roots + slots)
    valid = sum(int(h.valid.sum()) for t in trees for h in t[1:])
    pending = sum(int(f[h.nodes].sum()) for t, f in zip(trees, flags)
                  for h in t)
    assert round(got["valid_slots"] * n_b) == valid > 0
    assert round(got["pending_rows"] * n_b) == pending > 0


def test_diffusion_counts_nothing(tmp_path):
    tr = _trainer(tmp_path)
    with train_tower.counting(tr) as c:
        tr.train_epoch(max_chunks=1)
    assert c.batches == 0
    assert set(c.per_batch().values()) == {0}
