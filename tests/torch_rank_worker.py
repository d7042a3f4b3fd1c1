"""The rank side of the port's seed-sharded and row-sharded tests:
scenarios that one rank of a spawned group runs (``run_group``), each
saving what the tests check to ``<out>/<scenario>_rank<r>.pt``. The ranks
import the port alone (never JAX), at the sizes of
test_torch_seed_trainer.py: 1,200 events, 40 + 40 nodes, bs 50,
index_chunk 200 (four superchunks), dims 16, top-5, the flagship (α, β)
ensemble, S = 4 seeds over D = 2 ranks; the row-sharded scenarios (the
``rows_*`` ones) run one seed over the D = 2 ranks, each rank holding 64
of the 128 padded node rows and 25 of each batch's 50 events."""

from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data import split_data, synthetic_stream
from zebra_tpu_torch.parallel.distributed import broadcast_one_to_all, rank
from zebra_tpu_torch.parallel.launch import launch
from zebra_tpu_torch.train import phase as phase_mod
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.node_classification import (
    collect_source_embeddings,
    run_node_classification,
)

S, D = 4, 2
# the --task node scenarios: the node decoder's steps, and the share of
# users whose events carry label 1
NODE_STEPS = 50
NODE_LABELS = 0.3
SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), lr=1e-3)
F32 = dict(memory_dtype="float32", message_dtype="float32")
PHASES = ("train", "val", "nn_val", "test", "nn_test")
# test_seed_sharded.py's fit comparison: JAX's _seed_trainer config
FIT = dict(data="synthetic", bs=50, index_chunk=200, node_dim=16,
           time_dim=16, memory_dim=16, topk=5, alpha_list=(0.1,),
           beta_list=(0.9,), n_degree=5, n_layer=2, lr=3e-3, n_epoch=2,
           patience=5, memory_dtype="float32", save_best=True)


def splits(n_events: int = 1200, label_users_frac: float = 0.0):
    data, ef = synthetic_stream(n_events=n_events, n_users=40, n_items=40,
                                edge_dim=4, seed=0,
                                label_users_frac=label_users_frac)
    return split_data(data.sources, data.destinations, data.timestamps,
                      data.edge_idxs, data.labels), ef


def trainer(ckpt: str, n_events: int = 1200, base=SMALL,
            label_users_frac: float = 0.0, **kw) -> Trainer:
    sp, ef = splits(n_events, label_users_frac)
    cfg = Config(**{**base, "checkpoint_dir": ckpt, **kw})
    return Trainer(cfg, sp, ef, device="cpu")


def run_phases(t: Trainer) -> dict:
    """train_epoch, validate, test: each phase's per-batch metrics, the
    train-end and test-end index, and the tables at the end."""
    tr = t.train_epoch()
    train_index = t.index_state.data.clone()
    val, nn_val = t.validate()
    test, nn_test = t.test()
    return dict(
        per_batch={p: r.per_batch for p, r in
                   zip(PHASES, (tr, val, nn_val, test, nn_test))},
        train_index=train_index, index=t.index_state.data.clone(),
        mem={k: v.clone() for k, v in t._memory_tables().items()},
        params={k: v.clone() for k, v in t.params.state_dict().items()},
        lanes=list(t._lanes), neg_base=np.asarray(t._neg_base))


def lane_tree(tree, lanes):
    """Lanes ``lanes`` of a stacked numpy params tree."""
    if isinstance(tree, dict):
        return {k: lane_tree(v, lanes) for k, v in tree.items()}
    if isinstance(tree, list):
        return [lane_tree(v, lanes) for v in tree]
    return np.asarray(tree)[lanes.start: lanes.stop]


# ------------------------------------------------------------- scenarios

def sc_lanes(tmp: str) -> dict:
    """2 ranks × S = 4 from JAX's stacked params (``<tmp>/params.pkl``),
    dropout 0, f32 tables."""
    t = trainer(os.path.join(tmp, "lanes"), parallel_runs=S, n_devices=D,
                dropout=0.0, **F32)
    with open(os.path.join(tmp, "params.pkl"), "rb") as f:
        bridge.load_trainer_params(t, lane_tree(pickle.load(f), t._lanes))
    return dict(run_phases(t), negs=t._draw_train_negs(0))


def sc_fit(tmp: str) -> dict:
    """``fit`` of S = 4 over 2 ranks (dropout 0.1), against sequential
    single-seed fits."""
    t = trainer(os.path.join(tmp, "fit"), 600, FIT, parallel_runs=S,
                n_devices=D)
    return dict(results=t.fit())


def sc_resume(tmp: str) -> dict:
    """An uninterrupted 3-epoch fit, and a 2-epoch fit resumed from its
    epoch-2 state file, both over 2 ranks with ``parallel_lr``."""
    kw = dict(n_epoch=3, patience=5, state_every=2, parallel_runs=S,
              n_devices=D, parallel_lr=(3e-3, 8e-4, 1e-3, 2e-3))
    full = trainer(os.path.join(tmp, "a"), **kw)
    ref = full.fit()
    half = trainer(os.path.join(tmp, "b"), **kw)
    half.fit(n_epoch=2)
    state = os.path.join(half.cfg.checkpoint_dir,
                         half.cfg.run_name() + ".state.ckpt")
    resumed = trainer(os.path.join(tmp, "b"), **kw)
    out = resumed.fit(resume_from=state)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    return dict(ref=ref, out=out, state=state,
                params_equal=same(full.params.parameters(),
                                  resumed.params.parameters()),
                mem_equal=same(full.mem, resumed.mem),
                index_equal=torch.equal(full.index_state.data,
                                        resumed.index_state.data))


def sc_serve(tmp: str) -> dict:
    """One epoch over 2 ranks, then its state file (the tests serve it)."""
    t = trainer(os.path.join(tmp, "serve"), parallel_runs=S, n_devices=D)
    t.train_epoch()
    t.validate()
    path = os.path.join(tmp, "serve", "sharded.state.ckpt")
    t.save_state(path)
    return dict(path=path, mem={k: v.clone() for k, v in
                                t._memory_tables().items()},
                index=t.index_state.data.clone())


def sc_stop(tmp: str) -> dict:
    """``request_stop`` on rank 1 alone, before the first superchunk."""
    t = trainer(os.path.join(tmp, "stop"), parallel_runs=S, n_devices=D)
    if rank() == 1:
        t.request_stop()
    out = t.fit(n_epoch=2)
    return dict(out=out, cursor=t._chunk_cursor)


def sc_branches(tmp: str) -> dict:
    """The pruning strategy and the time tower (S = 2 over 2 ranks), one
    epoch and validate each."""
    res = {}
    for name, kw in (("pruning", dict(tppr_strategy="pruning",
                                      beta_list=(0.5, 0.95), n_degree=4,
                                      n_layer=2)),
                     ("time", dict(embedding_module="time"))):
        t = trainer(os.path.join(tmp, name), parallel_runs=2, n_devices=D,
                    **F32, **kw)
        tr = t.train_epoch()
        val, nn_val = t.validate()
        res[name] = dict(train=tr.ap, val=val.ap, nn_val=nn_val.ap)
    return res


def sc_fit_one_lane(tmp: str) -> dict:
    """``fit`` of S = 2 over 2 ranks: one lane per rank."""
    t = trainer(os.path.join(tmp, "one_lane"), parallel_runs=2, n_devices=D,
                n_epoch=1, **F32)
    return dict(results=t.fit(), lanes=list(t._lanes))


def sc_host_backup(tmp: str) -> dict:
    """S = 4 over 2 ranks, validate and test under each protocol."""
    res = {}
    for host in (False, True):
        t = trainer(os.path.join(tmp, f"hb{int(host)}"), parallel_runs=S,
                    n_devices=D, host_backup=host, **F32)
        assert t.host_backup is host
        res[host] = run_phases(t)
    return res


def sc_random_bases(tmp: str) -> dict:
    """``enable_random`` from a global numpy state seeded 100 + rank: the
    negative bases each rank holds, and a broadcast of each rank's own
    draw."""
    np.random.seed(100 + rank())
    own = np.random.randint(0, 2**31 - 1, S)
    np.random.seed(100 + rank())
    t = trainer(os.path.join(tmp, "random"), parallel_runs=S, n_devices=D,
                enable_random=True)
    return dict(neg_base=np.asarray(t._neg_base), lanes=list(t._lanes),
                own=own, broadcast=broadcast_one_to_all(own))


@contextlib.contextmanager
def recorded_scores(out: list):
    """Record every batch's (pos, neg) probabilities [2, b] as a phase's
    metrics read them (``train/phase.py``'s accuracy, whole batches, in one
    process and after a row-sharded phase's gather)."""
    acc = phase_mod.masked_rank_acc

    def spy(pos, neg, valid):
        out.append(torch.stack([pos, neg]).detach().cpu().clone())
        return acc(pos, neg, valid)

    phase_mod.masked_rank_acc = spy
    try:
        yield
    finally:
        phase_mod.masked_rank_acc = acc


def run_rows(t: Trainer, state: str = None) -> dict:
    """``run_phases`` of a row-sharded Trainer (or of one process): the
    index (None where none is kept) and the tables gathered into the
    one-process layout after the train epoch and at the end, the exchange's
    counts per kind; with ``state``, the train-end state file written
    there."""
    scores = []
    with recorded_scores(scores):
        tr = t.train_epoch()
    mem, index = t.gathered_state()
    train_mem = {k: v.clone() for k, v in mem._asdict().items()}
    train_index = None if index is None else index.data.clone()
    if state is not None:
        t.save_state(state)
    with recorded_scores(scores):
        val, nn_val = t.validate()
        test, nn_test = t.test()
    mem, index = t.gathered_state()
    phases = (tr, val, nn_val, test, nn_test)
    ex = t.exchange
    return dict(
        per_batch={p: r.per_batch for p, r in zip(PHASES, phases)},
        waves={p: r.waves for p, r in zip(PHASES, phases)},
        index_seconds={p: r.index_seconds for p, r in zip(PHASES, phases)},
        train_index=train_index,
        index=None if index is None else index.data.clone(),
        train_mem=train_mem, mem={k: v.clone() for k, v in
                                  mem._asdict().items()},
        params={k: v.clone() for k, v in t.params.state_dict().items()},
        local_rows=t.mem.memory.shape[0],
        backend=None if ex is None else ex.backend,
        stats=None if ex is None else {k: list(v)
                                       for k, v in ex.stats.items()},
        ids=None if ex is None else {k: list(v) for k, v in ex.ids.items()},
        negs=t._draw_train_negs(0), neg_base=t._neg_base, state=state,
        cfg=t.cfg, scores=torch.stack(scores))


def sc_rows_jax(tmp: str) -> dict:
    """One seed over 2 ranks from JAX's params (``<tmp>/rows_params.pkl``),
    dropout 0, f32 tables."""
    t = trainer(os.path.join(tmp, "rows_jax"), n_devices=D, dropout=0.0,
                **F32)
    with open(os.path.join(tmp, "rows_params.pkl"), "rb") as f:
        bridge.load_trainer_params(t, pickle.load(f))
    return run_rows(t)


def sc_rows_dropout(tmp: str) -> dict:
    """One seed over 2 ranks with the default dropout (0.1) and f32 tables,
    from the Trainer's own init: the first superchunk of a train epoch."""
    t = trainer(os.path.join(tmp, "rows_dropout"), n_devices=D, **F32)
    r = t.train_epoch(max_chunks=1)
    return dict(per_batch=r.per_batch,
                params={k: v.clone() for k, v in
                        t.params.state_dict().items()})


def sc_rows_host_backup(tmp: str) -> dict:
    """Row-sharded validate() and test() from one train-end state under
    each backup protocol (the host one restored from the state file)."""
    t = trainer(os.path.join(tmp, "rows_hb"), n_devices=D, host_backup=False,
                **F32)
    t.train_epoch()
    path = os.path.join(tmp, "rows_hb", "train_end.state.ckpt")
    t.save_state(path)
    res = {}
    for host in (False, True):
        if host:
            t.host_backup = True
            t.restore_state(path)
        phases = (*t.validate(), *t.test())
        mem, index = t.gathered_state()
        res[host] = dict(per_batch=[p.per_batch for p in phases],
                         mem={k: v.clone() for k, v in
                              mem._asdict().items()},
                         index=index.data.clone())
    return res


def sc_rows_resume(tmp: str) -> dict:
    """An uninterrupted 2-epoch row-sharded fit, and one resumed from the
    epoch-1 state file of a 1-epoch fit."""
    kw = dict(n_epoch=2, patience=5, state_every=1, n_devices=D)
    full = trainer(os.path.join(tmp, "rows_a"), **kw)
    ref = full.fit()
    half = trainer(os.path.join(tmp, "rows_b"), **kw)
    half.fit(n_epoch=1)
    state = os.path.join(half.cfg.checkpoint_dir,
                         half.cfg.run_name() + ".state.ckpt")
    resumed = trainer(os.path.join(tmp, "rows_b"), **kw)
    out = resumed.fit(resume_from=state)
    mem_a, idx_a = full.gathered_state()
    mem_b, idx_b = resumed.gathered_state()
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    return dict(ref=ref, out=out, state=state,
                params_equal=same(full.params.parameters(),
                                  resumed.params.parameters()),
                mem_equal=same(mem_a, mem_b),
                index_equal=torch.equal(idx_a.data, idx_b.data),
                rank_params={k: v.clone() for k, v in
                             full.params.state_dict().items()})


def sc_rows_state(tmp: str) -> dict:
    """One row-sharded epoch and validate(), then its state file (the tests
    restore it with D = 1 and D = 2 and serve it)."""
    t = trainer(os.path.join(tmp, "rows_state"), n_devices=D)
    t.train_epoch()
    t.validate()
    path = os.path.join(tmp, "rows_state", "rows.state.ckpt")
    t.save_state(path)
    mem, index = t.gathered_state()
    res = dict(path=path, mem={k: v.clone() for k, v in
                               mem._asdict().items()},
               index=index.data.clone())
    # a second Trainer of two ranks restores it and carries on alike
    again = trainer(os.path.join(tmp, "rows_state2"), n_devices=D)
    again.restore_state(path)
    a, b = t.train_epoch(), again.train_epoch()
    res["restored_equal"] = bool(np.array_equal(a.per_batch, b.per_batch))
    return res


def sc_rows_aligned(tmp: str) -> dict:
    """Owner-aligned waves over 2 ranks: with the id interleave (auto) and
    without it, and neither (the auto rule on one host), one epoch and
    validate each, and the plain and interleaved runs' state files."""
    res = {}
    for name, kw in (("plain", {}),
                     ("aligned", dict(owner_aligned_waves=True,
                                      interleave_node_ids=False)),
                     ("interleaved", dict(owner_aligned_waves=True))):
        t = trainer(os.path.join(tmp, f"rows_{name}"), n_devices=D, **F32,
                    **kw)
        tr = t.train_epoch()
        val, nn_val = t.validate()
        mem, index = t.gathered_state()
        res[name] = dict(train=tr.ap, val=val.ap, nn_val=nn_val.ap,
                         waves=tr.waves, shards=t.cfg.interleave_shards,
                         wave_shards=t._wave_shards,
                         index=index.data.clone(),
                         memory=mem.memory.clone())
        if name != "aligned":
            path = os.path.join(tmp, f"rows_{name}", "run.state.ckpt")
            t.save_state(path)
            res[name]["path"] = path
    return res


# the options the row-sharded layout runs beyond the flagship's, each held
# against the one-process port and JAX's n_devices=2 Trainer, at JAX's
# default lr (tests/test_torch_row_sharded_pruning.py says why)
OPTION_LR = 1e-4
ROW_OPTIONS = {
    "pruning": dict(tppr_strategy="pruning", beta_list=(0.5, 0.95),
                    n_degree=4, n_layer=2),
    "messages": dict(message_function="mlp",
                     use_source_embedding_in_message=True,
                     use_destination_embedding_in_message=True),
    "mean": dict(aggregator="mean"),
    "lazy": dict(lazy_unique_cap=-1),
    "identity": dict(embedding_module="identity"),
    "time": dict(embedding_module="time"),
    "graph_sum": dict(embedding_module="graph_sum", n_degree=4, n_layer=2),
    "graph_attention": dict(embedding_module="graph_attention", n_degree=4,
                            n_layer=2, n_head=2),
    "graph_attention_il": dict(embedding_module="graph_attention",
                               n_degree=4, n_layer=2, n_head=2,
                               owner_aligned_waves=True),
    "node": dict(task="node"),
}
# a compaction cap the batches' distinct neighbors overflow
OVERFLOW_CAP = 20


def option_trainer(tmp: str, name: str, n_devices: int = D,
                   **kw) -> Trainer:
    """A Trainer of option ``name`` (:data:`ROW_OPTIONS`) at dropout 0 with
    f32 tables, from JAX's params where ``<tmp>/<name>_params.pkl``
    exists."""
    t = trainer(os.path.join(tmp, f"{name}_{n_devices}"), n_devices=n_devices,
                lr=OPTION_LR, dropout=0.0, **F32,
                **{**ROW_OPTIONS[name], **kw})
    path = os.path.join(tmp, f"{name}_params.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            bridge.load_trainer_params(t, pickle.load(f))
    return t


def row_option(name: str):
    """The scenario of option ``name`` on the ranks: ``run_rows`` with its
    train-end state file."""
    def scenario(tmp: str) -> dict:
        t = option_trainer(tmp, name)
        return run_rows(t, os.path.join(tmp, f"{name}.state.ckpt"))
    scenario.__doc__ = f"{name} over {D} ranks (``option_trainer``)."
    return scenario


for _name in ROW_OPTIONS:
    globals()[f"sc_rows_{_name}"] = row_option(_name)


def sc_rows_overflow(tmp: str) -> dict:
    """A train epoch over 2 ranks whose compaction cap overflows (the
    epoch reruns per position), and one per position from the start."""
    res = {}
    for cap in (OVERFLOW_CAP, 0):
        t = option_trainer(tmp, "lazy", lazy_unique_cap=cap)
        r = t.train_epoch()
        mem, _ = t.gathered_state()
        res[cap] = dict(per_batch=r.per_batch, overflow=r.overflow,
                        fallback=t._lazy_fallback,
                        params={k: v.clone() for k, v in
                                t.params.state_dict().items()},
                        mem={k: v.clone() for k, v in mem._asdict().items()})
    return res


# the options whose other paths (host backups, fit's resume) the ranks run
PATH_OPTIONS = ("pruning", "mean", "graph_attention")


def sc_rows_paths(tmp: str) -> dict:
    """Each option of :data:`PATH_OPTIONS` over 2 ranks: validate() and
    test() from one train-end state under each backup protocol, and a
    2-epoch ``fit`` against a 1-epoch fit resumed from its state file."""
    res = {}
    for name in PATH_OPTIONS:
        t = option_trainer(tmp, name, host_backup=False)
        t.train_epoch()
        path = os.path.join(tmp, f"{name}_paths.state.ckpt")
        t.save_state(path)
        backups = {}
        for host in (False, True):
            if host:
                t.host_backup = True
                t.restore_state(path)
            phases = (*t.validate(), *t.test())
            mem, _ = t.gathered_state()
            backups[host] = dict(per_batch=[p.per_batch for p in phases],
                                 mem={k: v.clone() for k, v in
                                      mem._asdict().items()})
        kw = dict(n_epoch=2, patience=5, state_every=1)
        full = option_trainer(os.path.join(tmp, f"{name}_a"), name, **kw)
        ref = full.fit()
        half = option_trainer(os.path.join(tmp, f"{name}_b"), name, **kw)
        half.fit(n_epoch=1)
        state = os.path.join(half.cfg.checkpoint_dir,
                             half.cfg.run_name() + ".state.ckpt")
        resumed = option_trainer(os.path.join(tmp, f"{name}_b"), name, **kw)
        out = resumed.fit(resume_from=state)
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
        res[name] = dict(
            backups=backups, ref=ref, out=out,
            params_equal=same(full.params.parameters(),
                              resumed.params.parameters()),
            mem_equal=same(full.gathered_state()[0],
                           resumed.gathered_state()[0]))
    return res


# the row-sharded paths whose marks tests/test_torch_marks.py pins
MARK_PATHS = {
    "streaming": {},
    "pruning": dict(tppr_strategy="pruning", n_degree=4, n_layer=2),
}


def sc_rows_marks(tmp: str) -> dict:
    """The mark names of a train superchunk over 2 ranks, per path of
    :data:`MARK_PATHS`, with the recorder's event factory a stand-in."""
    from zebra_tpu_torch.utils import profiling

    profiling.mark_event = object
    res = {}
    for name, kw in MARK_PATHS.items():
        t = trainer(os.path.join(tmp, f"marks_{name}"), n_devices=D, **kw)
        marks: list = []
        t.train_epoch(max_chunks=1, marks=marks)
        res[name] = [n for n, _ in marks]
    return res


def replay_embeddings(t: Trainer) -> dict:
    """The node-classification replay's source embeddings of the train,
    val and test streams, from fresh tables at full N (the valid events')."""
    mem, index = t._fresh_state(whole=True)
    out = {}
    for name in ("train", "val", "test"):
        ps = t._streams[name]
        mem, index, e, _ = collect_source_embeddings(
            t.cfg, t.params, mem, index, t.edge_feats, ps)
        out[name] = e[torch.from_numpy(ps.host["valid"])].clone()
    return out


def sc_rows_node(tmp: str) -> dict:
    """``--task node`` on 2 ranks: the replay's embeddings from JAX's
    params, then a train epoch and the node-classification protocol."""
    t = option_trainer(tmp, "node", label_users_frac=NODE_LABELS)
    embs = replay_embeddings(t)
    t.train_epoch()
    aucs = run_node_classification(t, n_steps=NODE_STEPS)
    return dict(embs=embs, aucs=aucs, local_rows=t.mem.memory.shape[0],
                params={k: v.clone() for k, v in
                        t.params.state_dict().items()})


def fail_on_rank_one() -> None:
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank() == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()


def _rank(scenarios, tmp: str) -> None:
    for name in scenarios:
        out = globals()[f"sc_{name}"](tmp)
        torch.save(out, os.path.join(tmp, f"{name}_rank{rank()}.pt"))


def run_group(scenarios, tmp: str) -> dict:
    """Run ``scenarios`` in order on D spawned CPU ranks (one torch thread
    each); returns each scenario's list of the ranks' results."""
    launch(_rank, D, (tuple(scenarios), str(tmp)), threads=1)
    return {name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"),
                              weights_only=False) for r in range(D)]
            for name in scenarios}
