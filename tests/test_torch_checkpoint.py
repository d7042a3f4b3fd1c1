"""The port's checkpoint files and Trainer state (zebra_tpu_torch/train/
checkpoint.py, Trainer.save_state/restore_state), after
tests/test_checkpoint.py and tests/test_preemption.py: a restored Trainer
continues bit for bit as the uninterrupted one, from an epoch boundary and
from a mid-epoch cursor; an incompatible config, a newer version and a
checkpoint of the JAX package are refused; bf16 tables round-trip exactly.
Sizes of test_torch_trainer.py (1,200 events, dims 16, top-5, index_chunk
200: four train superchunks), the port's default bf16 tables."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.train.checkpoint import (
    MAGIC,
    VERSION,
    load_checkpoint,
    save_checkpoint,
)
from zebra_tpu_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), lr=3e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process for the module: the suite runs
    in several worker processes at once, and at these sizes more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_trainer(tmp_path, n_events=1200, edge_dim=4, **kw):
    data, ef = synthetic_stream(n_events=n_events, n_users=40, n_items=40,
                                edge_dim=edge_dim, seed=0)
    cfg = Config(**{**SMALL, "checkpoint_dir": str(tmp_path / "ckpt"), **kw})
    return Trainer(cfg, split_data(data.sources, data.destinations,
                                   data.timestamps, data.edge_idxs,
                                   data.labels), ef, device="cpu")


def assert_same_state(a: Trainer, b: Trainer):
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.mem, b.mem):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a.index_state.data, b.index_state.data)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key, v in st.items():
            assert torch.equal(v, sb["state"][i][key]), (i, key)
    assert torch.equal(a._dropout.get_state(), b._dropout.get_state())
    assert (a._epoch_id, a._chunk_cursor) == (b._epoch_id, b._chunk_cursor)


def test_save_restore_continues_bit_identically(tmp_path):
    path = str(tmp_path / "full.ckpt")
    t1 = port_trainer(tmp_path)
    t1.train_epoch()
    t1.validate()
    t1.save_state(path, epoch=1)
    cont = t1.train_epoch()

    t2 = port_trainer(tmp_path)
    assert t2.restore_state(path) == (1, 0)
    res = t2.train_epoch()
    np.testing.assert_array_equal(cont.per_batch, res.per_batch)
    assert_same_state(t1, t2)


def test_mid_epoch_cursor_resume_is_bit_equal(tmp_path):
    """max_chunks=2, save, then start_chunk=2 in a fresh Trainer lands on
    the uninterrupted epoch's state; the two windows' metrics are the
    uninterrupted epoch's."""
    path = str(tmp_path / "mid.ckpt")
    t1 = port_trainer(tmp_path)
    assert t1._streams["train"].n_chunks == 4
    full = t1.train_epoch()

    t2 = port_trainer(tmp_path)
    first = t2.train_epoch(max_chunks=2)
    assert (t2._chunk_cursor, t2._epoch_id) == (2, 0)
    t2.save_state(path, epoch=0)

    t3 = port_trainer(tmp_path)
    assert t3.restore_state(path) == (0, 2)
    rest = t3.train_epoch(start_chunk=2)
    assert (t3._chunk_cursor, t3._epoch_id) == (0, 1)
    assert_same_state(t1, t3)
    np.testing.assert_array_equal(
        np.concatenate([first.per_batch, rest.per_batch]), full.per_batch)
    assert first.waves + rest.waves == full.waves


def test_request_stop_ends_the_epoch_after_one_superchunk(tmp_path):
    trainer = port_trainer(tmp_path)
    trainer.request_stop()
    r = trainer.train_epoch()
    assert (trainer._chunk_cursor, trainer._epoch_id) == (1, 0)
    assert r.per_batch.shape[0] == len(trainer._streams["train"].n_valid()) // 4


def test_empty_window_raises(tmp_path):
    with pytest.raises(ValueError, match="empty superchunk window"):
        port_trainer(tmp_path).train_epoch(start_chunk=4)


@pytest.mark.parametrize("kw,field", [
    (dict(topk=4), "topk"),
    (dict(node_dim=8, memory_dim=8), "memory_dim"),
    (dict(alpha_list=(0.2, 0.1)), "alpha_list"),
    (dict(memory_dtype="float32"), "memory_dtype"),
    (dict(n_events=600), "n_edges"),
], ids=["topk", "dims", "alpha", "dtype", "stream"])
def test_incompatible_config_is_refused_with_the_field_diff(tmp_path, kw,
                                                            field):
    path = str(tmp_path / "compat.ckpt")
    port_trainer(tmp_path).save_state(path, epoch=1)
    other = port_trainer(tmp_path, **kw)
    with pytest.raises(ValueError, match=f"{field}: checkpoint="):
        other.restore_state(path)
    assert port_trainer(tmp_path).restore_state(path) == (1, 0)


def test_newer_version_is_refused(tmp_path):
    path = str(tmp_path / "new.ckpt")
    torch.save({"magic": MAGIC, "version": VERSION + 98, "tree": {}}, path)
    with pytest.raises(ValueError, match=f"version {VERSION + 98}"):
        load_checkpoint(path)


def test_other_files_are_refused(tmp_path):
    path = str(tmp_path / "other.ckpt")
    torch.save({"weights": torch.ones(2)}, path)
    with pytest.raises(ValueError, match="not a zebra_tpu_torch checkpoint"):
        load_checkpoint(path)


def test_jax_checkpoint_is_refused_without_importing_the_jax_package(
        tmp_path):
    """A checkpoint of the JAX package (a pickle of zebra_tpu classes and
    numpy arrays) is refused by the port in a fresh interpreter that never
    imports zebra_tpu or jax."""
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, {"cfg": JaxConfig(), "epoch": 1,
                               "params": {"fc1": {"w": np.ones((2, 2))}}})
    code = (
        "import sys\n"
        "from zebra_tpu_torch.train.checkpoint import load_checkpoint\n"
        "try:\n"
        f"    load_checkpoint({path!r})\n"
        "    raise SystemExit('loaded')\n"
        "except ValueError as e:\n"
        "    assert 'JAX package' in str(e), e\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zebra_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    trainer = port_trainer(tmp_path)
    with pytest.raises(ValueError, match="not a zebra_tpu_torch checkpoint"):
        trainer.restore_state(path)


def test_bf16_tables_round_trip_exactly(tmp_path):
    path = str(tmp_path / "bf16.ckpt")
    t1 = port_trainer(tmp_path)
    t1.train_epoch()
    assert t1.mem.memory.dtype == torch.bfloat16
    t1.save_state(path, epoch=1)
    tree = load_checkpoint(path)
    assert tree["mem"]["memory"].dtype == torch.bfloat16
    assert tree["mem"]["messages"].dtype == torch.bfloat16
    t2 = port_trainer(tmp_path)
    t2.restore_state(path)
    for x, y in zip(t1.mem, t2.mem):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_restore_keeps_adam_on_the_live_parameters(tmp_path):
    """restore_state loads the params in place, so Adam's state belongs to
    the tensors the Trainer trains, and the next step moves them."""
    path = str(tmp_path / "adam.ckpt")
    t1 = port_trainer(tmp_path)
    t1.train_epoch()
    t1.save_state(path, epoch=1)
    t2 = port_trainer(tmp_path)
    live = list(t2.params.parameters())
    t2.restore_state(path)
    assert all(a is b for a, b in zip(live, t2.params.parameters()))
    group = t2.optimizer.param_groups[0]["params"]
    assert all(a is b for a, b in zip(group, live))
    assert set(t2.optimizer.state) == set(live)
    before = [p.detach().clone() for p in live]
    t2.train_epoch()
    assert not all(torch.equal(a, b) for a, b in zip(before, live))


def test_save_checkpoint_writes_through_a_temporary_file(tmp_path):
    path = str(tmp_path / "x.ckpt")
    tree = {"t": torch.arange(3), "cfg": {"alpha_list": (0.1,), "x": None},
            "l": [1, 2.5, "s"]}
    save_checkpoint(path, tree)
    assert not os.path.exists(path + ".tmp")
    got = load_checkpoint(path)
    assert torch.equal(got["t"], tree["t"])
    assert got["cfg"] == tree["cfg"] and got["l"] == tree["l"]
    # the file is a plain torch.save payload: weights_only reads it
    payload = torch.load(path, weights_only=True)
    assert payload["magic"] == MAGIC and payload["version"] == VERSION


def test_checkpoint_is_not_a_pickle_of_classes(tmp_path):
    """The state file holds tensors and plain values only: the config as a
    dict, the memory as a dict of tensors."""
    path = str(tmp_path / "s.ckpt")
    trainer = port_trainer(tmp_path)
    trainer.save_state(path)
    tree = load_checkpoint(path)
    assert isinstance(tree["cfg"], dict) and isinstance(tree["mem"], dict)
    assert Config.from_dict(tree["cfg"]) == trainer.cfg
    assert set(tree["mem"]) == set(trainer.mem._fields)
    assert isinstance(tree["dropout"], torch.Tensor)
