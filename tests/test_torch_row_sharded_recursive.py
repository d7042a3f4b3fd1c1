"""The recursive towers on the row-sharded layout, ``graph_sum`` here
(``graph_attention`` in test_torch_row_sharded_attention.py; one seed
over D = 2 CPU ranks, tests/torch_rank_worker.py's ``sc_rows_graph_sum``):
every rank builds the whole batch's hop tree over the adjacency index it
holds whole (``models/embedding.py:hop_tree``), fetches each block's
distinct ids with an inverse (``train/phase.py:block_tree``), and combines
its block's tree over the fetched rows (``combine_tree``, the arithmetic
of the one-process tower). Held against the one-process port and JAX's
``Trainer(n_devices=2)`` from JAX's params with test_torch_row_sharded.py's
option bars (``option_tests``; its "options" section gives them and their
reasons), n_degree 4, n_layer 2. The distinct fetch is held against the
duplicated count on one batch."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import option_runs, option_tests
from tests.torch_rank_worker import option_trainer
from zebra_tpu_torch.models.embedding import hop_tree
from zebra_tpu_torch.train import memory_budget as mb
from zebra_tpu_torch.train.phase import block_tree

NAMES = ["graph_sum"]
globals().update(option_tests(NAMES))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_recursive")


@pytest.fixture(scope="module")
def runs(tmp):
    return option_runs(tmp, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_the_fetch_takes_distinct_ids(runs, name):
    """Over the run, the tower fetch moves far fewer rows than the ids its
    blocks name; no wave, no index state."""
    for r in runs[name]["ranks"]:
        fetched, named = r["ids"]["tower_fetch"]
        assert 0 < fetched < named / 4, (fetched, named)
        assert set(r["waves"].values()) == {0} and r["index"] is None


@pytest.mark.parametrize("rank", [0, 1])
def test_one_batch_distinct_fetch(tmp_path, rank):
    """One train batch's hop tree split into the two blocks: each block's
    ids are distinct, map back to the tree's ids through the inverse, and
    number fewer than the tree's 3b'·(1 + n + n²) per block."""
    t = option_trainer(str(tmp_path), "graph_attention", 1)
    s = t._streams["train"].stream
    b, world = t.cfg.bs, 2
    idx = slice(10 * b, 11 * b)
    roots = torch.cat([s.src[idx], s.dst[idx], s.dst[idx]])
    times = torch.cat([s.t[idx]] * 3)
    tree = hop_tree(t.cfg, t.full_nbr_index, roots, times)
    uniq, hops, named = block_tree(tree, world, t.cfg.n_nodes, rank)
    n = t.cfg.n_degree
    per_block = 3 * (b // world) * (1 + n + n * n)
    assert named == world * per_block
    assert uniq.shape[0] == world and uniq.shape[1] < per_block
    mine = uniq[rank]
    real = mine[: len(torch.unique(mine))]
    assert len(torch.unique(real)) == len(real)
    # the block's tree, named through its places, is the whole tree's part
    whole = [h.nodes.view(3, world, -1)[:, rank].reshape(-1) for h in tree]
    for h, want in zip(hops, whole):
        assert torch.equal(mine[h.nodes], want)
    print(f"block {rank}: {uniq.shape[1]} rows fetched for {per_block} "
          f"ids named")
    np.testing.assert_array_less(uniq.shape[1], per_block)


def test_guard_counts_the_adjacency_and_the_fetch(tmp_path):
    """Every rank holds the adjacency indices whole and a batch's distinct
    fetch at its largest: the guard adds both to its estimates."""
    t = option_trainer(str(tmp_path), "graph_sum", 1)
    cfg = t.cfg
    tree_ids = 3 * cfg.bs * (1 + cfg.n_degree + cfg.n_degree ** 2)
    assert mb.fetch_bytes(cfg, 2) == 2 * tree_ids * mb.row_bytes(cfg)
    assert mb.fetch_bytes(cfg, 1) == 0
    assert mb.fetch_bytes(cfg.replace(embedding_module="time"), 2) == 0
    held = mb.adjacency_bytes(t.train_nbr_index, t.full_nbr_index)
    ix = t.full_nbr_index
    assert held > ix.arena.numel() * 4 + ix.keys.numel() * 8
    plain = mb.budget(cfg, 1, 2**30, 64)
    more = mb.budget(cfg, 1, 2**30, 64, held + mb.fetch_bytes(cfg, 2))
    assert more.device - plain.device == more.host - plain.host == (
        held + mb.fetch_bytes(cfg, 2))
