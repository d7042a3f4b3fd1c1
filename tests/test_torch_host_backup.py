"""The host-backup protocol of validate() and test() (``host_backup``:
the train-end and val-end tables wait in host memory, the flush runs in
place) and the device-memory guard (zebra_tpu_torch/train/
memory_budget.py), after tests/test_seed_sharded.py:158-243.

Bars: ``host_backup=True`` bit-equal to ``False`` (every phase's per-batch
metrics, the end tables and the index) for one seed, for S = 2 and for
S = 4 over two CPU ranks (tests/torch_rank_worker.py); the port's
host-backup run against JAX's at test_torch_trainer.py's f32 bars (1e-4),
from the same params with dropout 0. The guard, with
``torch.cuda.mem_get_info`` faked as JAX's test fakes ``memory_stats``, at
the node count of Wiki-Talk (1,140,096) with the flagship's widths."""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.torch_rank_worker import F32, PHASES, SMALL, run_group, run_phases
from tests.torch_rank_worker import trainer as port
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.train import memory_budget as mb

JAX_ATOL = 1e-4


def _assert_runs_equal(a, b):
    for p in PHASES:
        np.testing.assert_array_equal(a["per_batch"][p], b["per_batch"][p],
                                      err_msg=p)
    for k in a["mem"]:
        assert torch.equal(a["mem"][k], b["mem"][k]), k
    assert torch.equal(a["index"], b["index"])


@pytest.mark.parametrize("layout", ["one_seed", "two_seeds", "sharded"])
def test_host_backup_is_bit_equal_to_the_device_protocol(layout, tmp_path):
    if layout == "sharded":
        for r in run_group(["host_backup"], tmp_path)["host_backup"]:
            _assert_runs_equal(r[True], r[False])
        return
    kw = dict(parallel_runs=2) if layout == "two_seeds" else {}
    runs = {}
    for host in (False, True):
        t = port(str(tmp_path / str(host)), host_backup=host, **F32, **kw)
        assert t.host_backup is host
        runs[host] = run_phases(t)
        if host:   # the buffers are made once and reused
            bufs = {k: [x.data_ptr() for x in v]
                    for k, v in t._host_tables.items()}
            t.validate()
            t.test()
            assert bufs == {k: [x.data_ptr() for x in v]
                            for k, v in t._host_tables.items()}
            assert t.host_copy_seconds > 0
    _assert_runs_equal(runs[True], runs[False])


def test_host_backup_matches_jax(tmp_path):
    data, ef = synthetic_stream(n_events=1200, n_users=40, n_items=40,
                                edge_dim=4, seed=0)
    cols = (data.sources, data.destinations, data.timestamps,
            data.edge_idxs, data.labels)
    jcfg = JaxConfig(**SMALL, **F32, dropout=0.0, host_backup=True,
                     checkpoint_dir=str(tmp_path))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    assert jt._host_backup
    pt = port(str(tmp_path), host_backup=True, dropout=0.0, **F32)
    assert pt.host_backup
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    got = run_phases(pt)["per_batch"]
    want = (jt.train_epoch(), *jt.validate(), *jt.test())
    for p, w in zip(PHASES, want):
        for i, f in enumerate(("loss", "ap", "auc", "acc")):
            assert abs(got[p][:, i].mean() - getattr(w, f)) <= JAX_ATOL, (p, f)


# The guard's boundaries: Wiki-Talk's 1,140,096 nodes (a multiple of 128,
# so N as the Trainer pads it) at the flagship's widths with JAX's default
# edge_dim 1: a row of 100 bf16 memory values, 201 + 1 bf16 message
# columns and three f32 columns is 616 B; the index 1,140,096 × 2(4·20 + 1)
# × 4 B. A rank of S lanes then needs copies · S · N · 616 B, S lanes'
# batch activations, one seed's flush scratch of N rows, and 2 · index.
WIKI_TALK = dict(node_dim=100, time_dim=100, memory_dim=100, topk=20,
                 alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95),
                 n_nodes=1140096, edge_dim=1)
ROW_B, INDEX_B = 616, 1140096 * 2 * 81 * 4
FREE = 40 * 2**30
CUDA = torch.device("cuda", 0)


def _largest_fit(copies: float) -> int:
    """The most lanes whose estimate fits the usable share of FREE."""
    room = (mb.USABLE_SHARE * FREE - mb.INDEX_COPIES * INDEX_B
            - mb.FLUSH_ROW_BYTES * 1140096)
    return int(room // (copies * 1140096 * ROW_B + mb.LANE_BATCH_BYTES))


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (FREE, 80 * 2**30))


def test_guard_estimate_uses_the_port_widths():
    cfg = Config(**WIKI_TALK)
    assert mb.row_bytes(cfg) == ROW_B and mb.index_bytes(cfg) == INDEX_B
    b = mb.budget(cfg, 3, FREE)
    assert b.tables == 3 * 1140096 * ROW_B
    rest = 2 * INDEX_B + 3 * mb.LANE_BATCH_BYTES + mb.FLUSH_ROW_BYTES * 1140096
    assert b.device == mb.DEVICE_COPIES * b.tables + rest
    assert b.host == mb.HOST_COPIES * b.tables + rest
    assert mb.HOST_COPIES < mb.DEVICE_COPIES and 0 < mb.USABLE_SHARE <= 1


def test_guard_decisions(fake_card, caplog):
    s_dev, s_host = _largest_fit(mb.DEVICE_COPIES), _largest_fit(
        mb.HOST_COPIES)
    assert 1 <= s_dev < s_host
    check = lambda s, hb: mb.check_memory_budget(
        Config(**WIKI_TALK, host_backup=hb), s, CUDA)
    # past the device protocol's budget: a raise when it is forced...
    with pytest.raises(ValueError, match="HBM budget exceeded"):
        check(s_dev + 1, False)
    # ...host backups in auto mode, where they fit
    with caplog.at_level("INFO", logger="zebra_tpu_torch"):
        assert check(s_dev + 1, None) is True
    assert "host memory (--host_backup auto" in caplog.text
    assert check(s_host, True) is True
    # past both: the raise is back
    for hb in (None, True):
        with pytest.raises(ValueError, match="HBM budget exceeded"):
            check(s_host + 1, hb)
    # below: no raise, no host backup unless asked for
    assert check(s_dev, None) is False and check(s_dev, False) is False


def test_guard_checks_nothing_on_the_cpu():
    for hb in (None, False, True):
        cfg = Config(**WIKI_TALK, host_backup=hb)
        assert mb.check_memory_budget(cfg, 10**4, "cpu") is bool(hb)
