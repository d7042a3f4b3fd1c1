"""The port's ensemble serving (EnsemblePredictor, ``from_checkpoint(run_index=
…, ensemble=True)``, zebra_tpu_torch/serve.py) against the JAX package's
EnsemblePredictor built from the same stacked parameters, memory and index,
and against the port's own single-seed predictors, S = 3.

Bars:
- against JAX, f32 tables: after three ``observe`` batches the shared index
  holds the merge bar of test_torch_merge.py, the members' memory within
  1e-5 and last_update exact (test_torch_serve.py's bars); ``score`` and
  ``member_scores`` within 1e-6;
- ``score`` is the mean of ``member_scores`` (within 1e-7: one f32 mean);
- member s of a seed-parallel state file against
  ``from_checkpoint(run_index=s)`` of that file within 1e-6 (a batched
  against an unbatched product), before and after ``observe``; the
  ensemble from the file bit-equal to ``EnsemblePredictor.from_trainer``;
- the JAX package's guards (tests/test_serve.py:381-420), same wording."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_checkpoint import port_trainer
from tests.test_torch_merge import assert_entries_close
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.streaming import init_tppr_state
from zebra_tpu.models.memory import init_memory
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu.serve import EnsemblePredictor as JaxEnsemblePredictor
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor

S, B = 3, 40


def _pair():
    """(stream, JAX ensemble, port ensemble) from the same S sets of JAX
    params (keys 0..S-1), zeroed f32 memory and an empty index."""
    data, ef = synthetic_stream(200, 30, 30, edge_dim=8, seed=0)
    jcfg = JaxConfig(
        node_dim=16, time_dim=16, memory_dim=16, topk=5,
        alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95),
        n_nodes=int(max(data.sources.max(), data.destinations.max())) + 1,
        n_edges=int(data.edge_idxs.max()) + 1, edge_dim=8,
        memory_dtype="float32", message_dtype="float32",
    )
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    jp = jax.tree.map(lambda *x: jnp.stack(x), *(
        init_tgn_params(jax.random.PRNGKey(s), jcfg) for s in range(S)))
    jmem = jax.tree.map(
        lambda x: jnp.stack([x] * S),
        init_memory(jcfg.n_nodes, jcfg.memory_dim, jcfg.msg_table_dim,
                    msg_dtype=jnp.float32, mem_dtype=jnp.float32))
    jidx = init_tppr_state(jcfg.n_tppr, jcfg.n_nodes, jcfg.topk)
    port = EnsemblePredictor(
        cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        bridge.memory_from_numpy(jax.tree.map(np.asarray, jmem), cfg, "cpu"),
        bridge.tppr_from_numpy(jax.tree.map(np.asarray, jidx), "cpu"),
        ef, device="cpu",
    )
    ref = JaxEnsemblePredictor(jcfg, jp, jmem, jidx, jnp.asarray(ef))
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs)
    return cols, ref, port


def test_ensemble_matches_jax():
    cols, ref, port = _pair()
    assert port.n_models == ref.n_models == S
    for lo in range(0, 3 * B, B):
        batch = [c[lo: lo + B] for c in cols]
        ref.observe(*batch)
        port.observe(*batch)

    m, k = ref.cfg.n_tppr, ref.cfg.topk
    split = lambda d: (d[:, : 4 * m * k].reshape(-1, m, 4, k),
                       d[:, 4 * m * k:])
    assert_entries_close(
        *split(bridge.tppr_to_numpy(port.index_state).data),
        *split(np.asarray(ref.index_state.data)))

    got = bridge.memory_to_numpy(port.mem, n_seeds=S)
    assert got.memory.shape == ref.mem.memory.shape
    assert np.abs(got.memory).max() > 0
    np.testing.assert_allclose(got.memory, np.asarray(ref.mem.memory),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.last_update,
                                  np.asarray(ref.mem.last_update))

    q = [c[3 * B: 4 * B] for c in cols[:3]]
    members = port.member_scores(*q)
    assert members.shape == (S, B) and np.isfinite(members).all()
    np.testing.assert_allclose(members, np.asarray(ref.member_scores(*q)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.score(*q), np.asarray(ref.score(*q)),
                               rtol=0, atol=1e-6)
    # the members differ (their own params), and score is their mean
    assert np.ptp(members, axis=0).max() > 1e-3
    np.testing.assert_allclose(port.score(*q), members.mean(0), rtol=0,
                               atol=1e-7)


@pytest.fixture(scope="module")
def seed_file(tmp_path_factory):
    """A seed-parallel Trainer after an epoch and validate(), and its state
    file."""
    tmp = tmp_path_factory.mktemp("ens")
    trainer = port_trainer(tmp, parallel_runs=S)
    trainer.train_epoch()
    trainer.validate()
    path = str(tmp / "seeds.ckpt")
    trainer.save_state(path, epoch=1)
    return trainer, path


def _requests(trainer, lo, hi):
    te = trainer.splits.test
    return (te.sources[lo:hi], te.destinations[lo:hi], te.timestamps[lo:hi],
            te.edge_idxs[lo:hi])


def test_members_equal_run_index_predictors(seed_file):
    trainer, path = seed_file
    ef = trainer.edge_feats.numpy()
    ens = LinkPredictor.from_checkpoint(path, edge_feats=ef, ensemble=True,
                                        device="cpu")
    assert isinstance(ens, EnsemblePredictor) and ens.n_models == S
    assert ens.cfg.parallel_runs == 1 and ens.cfg.parallel_lr is None
    members = [LinkPredictor.from_checkpoint(path, edge_feats=ef,
                                             run_index=s, device="cpu")
               for s in range(S)]
    assert all(type(m) is LinkPredictor for m in members)
    src, dst, t, _ = _requests(trainer, 0, 64)

    def check():
        per = np.stack([m.score(src, dst, t) for m in members])
        np.testing.assert_allclose(ens.member_scores(src, dst, t), per,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(ens.score(src, dst, t), per.mean(0),
                                   rtol=0, atol=1e-6)

    check()
    for lo in range(64, 184, 40):
        batch = _requests(trainer, lo, lo + 40)
        ens.observe(*batch)
        for m in members:
            m.observe(*batch)
    for s, m in enumerate(members):
        assert torch.equal(m.index_state.data, ens.index_state.data)
        n = m.cfg.n_nodes
        torch.testing.assert_close(ens.mem.memory[s * n: (s + 1) * n],
                                   m.mem.memory, rtol=0, atol=1e-2)
    check()


def test_ensemble_from_checkpoint_equals_from_trainer(seed_file):
    trainer, path = seed_file
    served = LinkPredictor.from_checkpoint(
        path, edge_feats=trainer.edge_feats.numpy(), ensemble=True,
        device="cpu")
    ref = EnsemblePredictor.from_trainer(trainer)
    src, dst, t, _ = _requests(trainer, 0, 64)
    np.testing.assert_array_equal(served.member_scores(src, dst, t),
                                  ref.member_scores(src, dst, t))
    for lo in range(64, 144, 40):
        batch = _requests(trainer, lo, lo + 40)
        served.observe(*batch)
        ref.observe(*batch)
    assert torch.equal(served.index_state.data, ref.index_state.data)
    for x, y in zip(served.mem, ref.mem):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(served.score(src, dst, t),
                                  ref.score(src, dst, t))
    # the Trainer trains on undisturbed: the predictor holds copies
    assert not torch.equal(ref.mem.memory,
                           trainer.mem.memory.to(ref.mem.memory.dtype))


@pytest.fixture(scope="module")
def single_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    trainer = port_trainer(tmp)
    trainer.train_epoch(max_chunks=1)
    path = str(tmp / "one.ckpt")
    trainer.save_state(path)
    return trainer, path


GUARDS = {
    "ensemble_of_one_seed": ("single", dict(ensemble=True), "seed-parallel"),
    "run_index_of_one_seed": ("single", dict(run_index=2), "single-seed"),
    "run_index_and_ensemble": ("seeds", dict(run_index=1, ensemble=True),
                               "not both"),
    "run_index_out_of_range": ("seeds", dict(run_index=S),
                               f"out of range for a {S}-seed"),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_from_checkpoint_guards(name, seed_file, single_file):
    which, kw, match = GUARDS[name]
    trainer, path = seed_file if which == "seeds" else single_file
    with pytest.raises(ValueError, match=match):
        LinkPredictor.from_checkpoint(
            path, edge_feats=trainer.edge_feats.numpy(), device="cpu", **kw)


def test_from_trainer_guards(seed_file, single_file):
    (par, _), (single, _) = seed_file, single_file
    with pytest.raises(ValueError, match="seed-parallel"):
        EnsemblePredictor.from_trainer(single)
    with pytest.raises(ValueError, match="EnsemblePredictor"):
        LinkPredictor.from_trainer(par)
    assert EnsemblePredictor.from_trainer(par).n_models == S
