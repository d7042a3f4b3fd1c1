"""The training loop of a recursive-tower cell (TGN's temporal graph
attention): ``Trainer.train_epoch`` one superchunk at a time, as
``train.py`` runs the diffusion cells, with no T-PPR query and no wave
scan.

Set-up builds one Trainer from the seed's stream and the tower's weights
(``weights_tgn``), runs the epoch's first superchunk while it records what
the check compares, then warms the epoch's last superchunk. It records
each of the first three steps' loss, Adam's first moment after step 1, the
parameters and the memory table as step 3's Adam leaves them; the hop
trees of the first three batches and of the superchunk's last three; for
the superchunk's last batch, the state its forward reads (the memory
tables, the parameters) and the parameters its Adam step leaves, its
embeddings and loss; the memory table after the superchunk; and the
tower's counts over the superchunk (roots, tree slots and gathered rows a
batch from the trees' shapes, valid slots and gathered rows with a pending
message), which it logs. The window (``train.window``) runs whole
superchunks from a fresh epoch, a new epoch after the last, until
``seconds`` have passed. With tracing, the epoch's first superchunk runs
once more under ``torch.profiler``: its trace (``trace.reduce``) and its
spans (``spans.reduce``) feed the per-layer readers.

The check holds what set-up recorded against ``reference/tgn.py`` fed the
same stream, weights and negatives: ``train.numbers``' loss, gradient and
change gaps over the first three steps, and its memory gap after step 3 as
``memory_gap_step3``; ``hops_gap``, the share of the six batches' tree
slots (neighbour, edge id, time, valid flag) that differ from the plain
search; and, fed the program's state before the superchunk's last batch
(its trees as full as the window's), that batch's ``late_emb_gap`` and
``late_loss_gap`` and ``memory_gap``, the memory table after the
superchunk.

Traffic keys: ``steps_checked`` (3); one seed."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import (checks, program, spans, streams, trace, weights_tgn,
                       work, work_tgn)
from benchmark.loops import train
from benchmark.reference import tgn
from benchmark.weights import edge_features


class State:
    """What set-up made and recorded."""


class Counts:
    """The recursive tower's work over the hop trees it is handed: roots,
    tree slots (every hop's ``n_degree`` per node) and gathered memory rows
    (roots and slots), from the trees' shapes; valid slots and gathered
    rows with a pending message (their flag in ``trainer``'s message table
    as the forward reads it), summed on the device."""

    def __init__(self, trainer):
        self.trainer, self.batches = trainer, 0
        self.roots = self.slots = self.rows = 0
        self.device = torch.zeros(2, dtype=torch.int64, device=trainer.device)

    def add(self, tree) -> None:
        pending = self.trainer.mem.messages[:, -1] != 0
        self.batches += 1
        self.roots += tree[0].nodes.numel()
        for h in tree[1:]:
            self.slots += h.valid.numel()
            self.device[0] += h.valid.sum()
        for h in tree:
            self.rows += h.nodes.numel()
            self.device[1] += pending[h.nodes].sum()

    def per_batch(self) -> Dict[str, float]:
        """Each count a batch (reads the device sums back)."""
        valid, pending = self.device.tolist()
        n = max(self.batches, 1)
        return dict(roots=self.roots / n, slots=self.slots / n,
                    rows=self.rows / n, valid_slots=valid / n,
                    pending_rows=pending / n)


@contextlib.contextmanager
def counting(trainer, keep=None):
    """For the block, count every hop tree the program builds (``Counts``)
    and hand each, with its call's index, to ``keep``."""
    import zebra_tpu_torch.models.embedding as emb

    orig, counts = emb.hop_tree, Counts(trainer)

    def hop_tree(*a, **kw):
        tree = orig(*a, **kw)
        if keep is not None:
            keep(counts.batches, tree)
        counts.add(tree)
        return tree

    emb.hop_tree = hop_tree
    try:
        yield counts
    finally:
        emb.hop_tree = orig


@contextlib.contextmanager
def _recording(st):
    """For the block (the first superchunk), record what the check
    compares: ``train._record``'s, the kept batches' hop trees, and the
    superchunk's last batch; yields the tower's ``Counts``."""
    import zebra_tpu_torch.train.phase as phase

    tr, n, late = st.trainer, st.steps, st.late
    kept = set(range(n)) | set(range(late + 1 - n, late + 1))
    np_ = lambda x: None if x is None else x.detach().cpu().numpy()
    st.trees = {}

    def keep(i, tree):
        if i in kept:
            st.trees[i] = [tgn.Level(np_(h.nodes), np_(h.times), np_(h.eidx),
                                     np_(h.valid)) for h in tree]

    orig_fwd, calls = phase._forward, [0]

    def forward(*a, **kw):
        out = orig_fwd(*a, **kw)
        if calls[0] == late:
            st.late_emb = out.detach().float().cpu()
        calls[0] += 1
        return out

    train._record(st, n)
    inner = tr.optimizer.step

    def step(*a, **kw):
        out = inner(*a, **kw)
        # the parameters of the last batch's forward, then its Adam
        # step's, with the memory tables its protocol starts from
        if st.count == late:
            st.late_params = program.parameters(tr)
        if st.count == late + 1:
            st.late_next = program.parameters(tr)
            st.late_state = [x.detach().float().cpu().clone()
                             for x in (tr.mem.memory, tr.mem.last_update,
                                       tr.mem.messages, tr.mem.msg_ts)]
        return out

    tr.optimizer.step, phase._forward = step, forward
    try:
        with counting(tr, keep) as counts:
            yield counts
    finally:
        phase._forward = orig_fwd
        train._unrecord(st)


def setup(h, warm: bool = True) -> State:
    from zebra_tpu_torch.train.loop import Trainer

    st = State()
    conf = h.config
    stream_seed, weight_seed, prog_seed, _ = streams.sub_seeds(h.seed)
    st.steps = int(h.traffic.get("steps_checked", 3))
    sc = conf["stream"]
    ev = streams.synthetic_events(sc["n_events"], sc["n_users"],
                                  sc["n_items"], int(stream_seed),
                                  sc.get("skew", 0.9))
    st.split = streams.split(ev)
    h.log("stream made and split")
    st.feats = edge_features(len(ev) + 1, sc["edge_dim"], int(weight_seed),
                             h.device)
    cfg = program.config(conf["model"], int(prog_seed))
    st.trainer = Trainer(cfg, program.splits(st.split),
                         st.feats.cpu().numpy(), device=h.device)
    h.log("trainer built")
    st.cfg, st.s, st.prog_seed = st.trainer.cfg, 1, int(prog_seed)
    st.dims = tgn.dims(st.cfg.node_dim, st.cfg.time_dim, sc["edge_dim"],
                       st.cfg.n_degree)
    st.params0 = weights_tgn.make_params(st.dims, st.cfg.n_layer,
                                         int(weight_seed), h.device)
    st.trainer.set_params(program.param_tree(st.params0))
    st.geo = streams.chunk_geometry(len(st.split.train), st.cfg.bs,
                                    st.cfg.index_chunk)
    n0 = min(st.geo["per_chunk"], st.geo["real_batches"])
    st.late = n0 - 1
    if st.late < st.steps:
        raise RuntimeError(f"the first superchunk holds {n0} batches, the "
                           f"check wants more than {st.steps}")
    with _recording(st) as counts:
        r0 = st.trainer.train_epoch(start_chunk=0, max_chunks=1)
    if len(r0.per_batch) != n0:
        raise RuntimeError(
            f"the first superchunk ran {len(r0.per_batch)} batches, the "
            f"benchmark expected {n0}")
    st.losses = np.asarray(r0.per_batch[: st.steps, 0], np.float64)
    st.late_loss = float(r0.per_batch[st.late, 0])
    st.memory_end = st.trainer.mem.memory.detach().float().cpu().clone()
    h.log("first superchunk run and recorded; a batch: " + ", ".join(
        f"{k} {v:.1f}" for k, v in counts.per_batch().items()))
    if warm and st.geo["n_chunks"] > 1:
        st.trainer.train_epoch(start_chunk=st.geo["n_chunks"] - 1,
                               max_chunks=1)
        h.log("last superchunk warmed")
    st.epoch, st.chunk = 1, 0
    train._sync(h)
    return st


def traced(h, st) -> Dict:
    """The epoch's first superchunk under the profiler: its trace, its
    span table and its batches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    while st.chunk != 0:
        train._advance(st)
    st.profiled_epoch = st.epoch
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if h.device.type == "cuda" else [])
    train._sync(h)
    with profile(activities=acts) as prof:
        with record_function(trace.SEGMENT):
            _, batches, _ = train._advance(st)
            train._sync(h)
    out = dict(trace=trace.reduce(prof), spans=spans.reduce(prof),
               batches=batches)
    for name, row in sorted(out["spans"].items()):
        h.log(f"span {name}: {row['calls']} calls, "
              f"{1e3 * row['host_s'] / batches:.4f} host ms, "
              f"{1e3 * row['device_s'] / batches:.4f} device ms, "
              f"{1e3 * row['idle_s'] / batches:.4f} idle ms a batch")
    return out


# ------------------------------------------------------------- the check

def _batch(st, i: int, negs, device) -> dict:
    """Train batch ``i`` as the reference takes it, with its hop tree."""
    cfg, tr = st.cfg, st.split.train
    sl = slice(i * cfg.bs, (i + 1) * cfg.bs)
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,
                                         device=device)
    roots = np.concatenate([tr.src[sl], tr.dst[sl], negs[sl]])
    return dict(src=as_t(tr.src[sl], torch.long),
                dst=as_t(tr.dst[sl], torch.long),
                neg=as_t(negs[sl], torch.long),
                t=as_t(tr.t[sl].astype(np.float32), torch.float32),
                eidx=as_t(tr.eidx[sl], torch.long),
                tree=tgn.hop_tree(st.adj, roots, np.tile(tr.t[sl], 3),
                                  cfg.n_degree, cfg.n_layer))


def reference(st, prec: tgn.Prec, device) -> Dict:
    """What the plain reference works out for set-up's recorded stretch:
    the hop trees, the first steps from zeroed memory, and the
    superchunk's last batch from the program's state before it."""
    cfg, tr = st.cfg, st.split.train
    n_real = st.split.n_nodes + 1
    if getattr(st, "adj", None) is None:
        st.adj = tgn.Adjacency(tr.src, tr.dst, tr.t, tr.eidx, n_real)
    negs = train._negs(st, 0)[0]
    batches = {i: _batch(st, i, negs, device) for i in sorted(st.trees)}
    feats = st.feats.to(device)
    p0 = {k: v.to(device) for k, v in st.params0.items()}
    steps, mem, final = tgn.train_steps(
        p0, prec, st.dims, cfg.n_head, cfg.lr, n_real, feats,
        [batches[i] for i in range(st.steps)])
    dev = lambda d: {k: v.to(device) for k, v in d.items()}
    late = tgn.memory_of(prec, st.dims, *(x[:n_real].to(device)
                                          for x in st.late_state))
    emb, loss = tgn.step_from(dev(st.late_params), dev(st.late_next), prec,
                              st.dims, cfg.n_head, late, feats,
                              batches[st.late])
    return dict(trees={i: bt["tree"] for i, bt in batches.items()},
                lanes=[dict(losses=[s.loss for s in steps],
                            grads=steps[0].grads, params=final,
                            memory=mem.memory, params0=p0)],
                late_emb=emb, late_loss=loss, memory_end=late.memory)


def program_side(st) -> Dict:
    """What the program produced, in the reference's shapes."""
    n_real = st.split.n_nodes + 1
    return dict(trees=st.trees, lanes=[dict(
        losses=list(st.losses),
        grads={k: v / 0.1 for k, v in st.moments.items()},
        params=st.params3, memory=st.memory2[:n_real])],
        late_emb=st.late_emb, late_loss=st.late_loss,
        memory_end=st.memory_end[:n_real])


def numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """``train.numbers``, its memory gap renamed ``memory_gap_step3``;
    ``hops_gap``; and the superchunk's last batch: ``late_emb_gap``,
    ``late_loss_gap`` and ``memory_gap`` after it."""
    out = train.numbers(got, ref)
    out["memory_gap_step3"] = out.pop("memory_gap")
    if sorted(got["trees"]) != sorted(ref["trees"]):
        out["hops_gap"] = 1.0
    else:
        out["hops_gap"] = max(tgn.tree_gap(ref["trees"][i], got["trees"][i])
                              for i in ref["trees"])
    out["late_emb_gap"] = checks.table_gap(got["late_emb"].cpu(),
                                           ref["late_emb"].cpu())
    out["late_loss_gap"] = checks.rel_gap([got["late_loss"]],
                                          [ref["late_loss"]])
    out["memory_gap"] = checks.table_gap(got["memory_end"].cpu(),
                                         ref["memory_end"].cpu())
    return out


# ------------------------------------------------------------ the readers

def model_flops(st, chunks: List[int], epoch: int) -> float:
    """The model FLOPs of these superchunks (``work_tgn``), the GRU's rows
    counted from the stream with ``epoch``'s negatives."""
    cfg, dm = st.cfg, st.dims
    tr, b = st.split.train, cfg.bs
    n_real = st.split.n_nodes + 1
    first = work.first_batches(tr.src, tr.dst, b, n_real)
    negs = train._negs(st, epoch)[0]
    ev = work_tgn.Events(tr.src, tr.dst, tr.t, n_real)
    n_b = -(-len(tr) // b)
    per_chunk = st.geo["per_chunk"]
    per_chunk_flops = {}
    for c in sorted(set(chunks)):
        bats = range(c * per_chunk, min(n_b, (c + 1) * per_chunk))
        rows = work_tgn.gru_rows_per_batch(ev, tr.src, tr.dst, negs, tr.t,
                                           b, cfg.n_degree, cfg.n_layer,
                                           first, bats)
        per_chunk_flops[c] = sum(
            work_tgn.train_batch_flops(
                len(tr.src[i * b:(i + 1) * b]), cfg.n_degree, cfg.n_layer,
                dm.d, dm.t, dm.e, r,
                work.commit_rows(tr.src[i * b:(i + 1) * b],
                                 tr.dst[i * b:(i + 1) * b], first, i))
            for i, r in zip(bats, rows))
    return float(sum(per_chunk_flops[c] for c in chunks))


def layer_context(h, st, win: Dict, tr: Dict) -> Dict:
    """What the per-layer readers read."""
    return dict(trace=tr.get("trace"), spans=tr.get("spans"),
                window_s=win["seconds"],
                events_per_s=win["events"] / win["seconds"],
                model_flops=model_flops(st, win["chunks"],
                                        st.profiled_epoch))


def run(h) -> Dict:
    st = setup(h)
    setup_s = time.perf_counter() - h.t_start
    win = train.window(h, st, h.seconds)
    h.log(f"window closed; graph_batches {st.trainer.graph_batches}, "
          f"eager_batches {st.trainer.eager_batches}")
    tr = traced(h, st) if h.trace else {}
    e2e = dict(win["e2e"], setup_s=setup_s)
    peak = h.memory_peak()
    del st.trainer
    h.free()
    ref = reference(st, tgn.Prec(), h.ref_device)
    nums = numbers(program_side(st), ref)
    h.log("checked against the reference")
    return dict(e2e=e2e, numbers=nums, attempted=win["batches"],
                failed=win["failed"], memory_peak=peak,
                layer=layer_context(h, st, win, tr) if h.trace else None)
