"""The training loop of a cell: ``Trainer.train_epoch`` one superchunk at a
time.

Set-up builds one Trainer from the seed's stream and weights, runs the
epoch's first superchunk through the window's own call while it records
what the check compares (each of the first three steps' loss from the
phase's metrics, Adam's first moment after step 1, the parameters and the
memory table as step 3's Adam leaves them, the index after the superchunk's
wave scan and the answers it gave the first three batches, or those
batches' BFS answers under pruning), then
warms the epoch's last superchunk, whose padded batch takes the masked
protocol. The window runs whole superchunks from a fresh epoch, a new epoch
after the last, until ``seconds`` have passed, and ends where the phase's
metrics were read back. With tracing, one more superchunk runs with the
program's CUDA-event marks and one, the epoch's first, under
``torch.profiler``. A cell that reports ``train_device_us_per_event`` runs
that profiled superchunk after the window without tracing too: the busy
device time of all its batches per train event.

Traffic keys: ``parallel_runs`` (seeds in one pass), ``steps_checked``
(3)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import checks, program, streams, trace, work
from benchmark.reference import bfs, santa
from benchmark.reference.model import Prec, Queries, train_steps
from benchmark.weights import edge_features, lane, make_params


# busy device microseconds per train event, over the epoch's first superchunk
DEVICE_TIME = "train_device_us_per_event"


class State:
    """What set-up made and recorded."""


def _record(st, steps: int) -> None:
    """Wrap the optimizer's step and the T-PPR answers (the wave scan's, or
    under pruning the BFS's) to record the first ``steps`` steps; undone by
    ``_unrecord``."""
    tr = st.trainer
    opt = tr.optimizer
    orig = opt.step
    st.count = 0

    def step(*a, **kw):
        out = orig(*a, **kw)
        st.count += 1
        if st.count == 1:
            st.moments = program.first_moments(tr)
        if st.count == steps:
            st.params3 = program.parameters(tr)
            st.memory2 = tr.mem.memory.detach().float().clone()
        return out

    opt.step = step
    st.bfs = []
    if st.cfg.tppr_strategy == "pruning":
        import zebra_tpu_torch.train.phase as phase
        orig_q = phase.pruned_queries

        def queries(*a, **kw):
            q = orig_q(*a, **kw)
            if len(st.bfs) < steps:
                st.bfs.append([x.detach().clone() for x in q])
            return q

        phase.pruned_queries = queries
        st.undo = (phase, "pruned_queries", orig_q)
    else:
        import zebra_tpu_torch.train.loop as loop
        orig_w = loop.wave_scan_chunk
        n = steps * st.cfg.bs

        def waves(*a, **kw):
            state, rows = orig_w(*a, **kw)
            if not hasattr(st, "rows"):
                st.rows = rows[:n].detach().clone()
            return state, rows

        loop.wave_scan_chunk = waves
        st.undo = (loop, "wave_scan_chunk", orig_w)


def _unrecord(st) -> None:
    del st.trainer.optimizer.step
    setattr(*st.undo)


def setup(h, warm: bool = True) -> State:
    from zebra_tpu_torch.train.loop import Trainer

    st = State()
    conf, tr = h.config, h.traffic
    stream_seed, weight_seed, prog_seed, _ = streams.sub_seeds(h.seed)
    s = int(tr.get("parallel_runs", 1))
    st.steps = int(tr.get("steps_checked", 3))
    sc = conf["stream"]
    ev = streams.synthetic_events(sc["n_events"], sc["n_users"],
                                  sc["n_items"], int(stream_seed),
                                  sc.get("skew", 0.9))
    st.split = streams.split(ev)
    h.log("stream made and split")
    st.feats = edge_features(len(ev) + 1, sc["edge_dim"], int(weight_seed),
                             h.device)
    extra = dict(parallel_runs=s) if s > 1 else {}
    cfg = program.config(conf["model"], int(prog_seed), **extra)
    st.trainer = Trainer(cfg, program.splits(st.split),
                         st.feats.cpu().numpy(), device=h.device)
    h.log("trainer built")
    st.cfg, st.s, st.prog_seed = st.trainer.cfg, s, int(prog_seed)
    st.dims = program.dims(st.cfg, sc["edge_dim"])
    st.params0 = make_params(st.dims, int(weight_seed), h.device, s)
    st.trainer.set_params(program.param_tree(st.params0))
    st.geo = streams.chunk_geometry(len(st.split.train), st.cfg.bs,
                                    st.cfg.index_chunk)
    _record(st, st.steps)
    r0 = st.trainer.train_epoch(start_chunk=0, max_chunks=1)
    _unrecord(st)
    h.log("first superchunk run and recorded")
    if len(r0.per_batch) != min(st.geo["per_chunk"], st.geo["real_batches"]):
        raise RuntimeError(
            f"the first superchunk ran {len(r0.per_batch)} batches, the "
            f"benchmark expected {st.geo['per_chunk']}")
    st.losses = np.asarray(r0.per_batch[: st.steps, ..., 0], np.float64)
    st.index0 = (None if st.trainer.index_state is None else
                 st.trainer.index_state.data.detach().cpu().numpy().copy())
    if warm and st.geo["n_chunks"] > 1:
        st.trainer.train_epoch(start_chunk=st.geo["n_chunks"] - 1,
                               max_chunks=1)
        h.log("last superchunk warmed")
    st.epoch, st.chunk = 1, 0
    _sync(h)
    return st


def _sync(h) -> None:
    if h.device.type == "cuda":
        torch.cuda.synchronize(h.device)


def _advance(st, marks: Optional[list] = None):
    """Run the next superchunk; returns (real events of all seeds, batches,
    the phase's metrics)."""
    c = st.chunk
    r = st.trainer.train_epoch(start_chunk=c, max_chunks=1, marks=marks)
    events = st.geo["chunk_events"][c] * st.s
    st.chunk = (c + 1) % st.geo["n_chunks"]
    if st.chunk == 0:
        st.epoch += 1
    return events, len(r.per_batch), r.per_batch


def window(h, st, seconds: float) -> Dict:
    events = batches = failed = 0
    chunks: List[int] = []
    t0 = time.perf_counter()
    while True:
        chunks.append(st.chunk)
        t1 = time.perf_counter()
        e, b, per_batch = _advance(st)
        events += e
        batches += b * st.s
        failed += int((~np.isfinite(per_batch[..., 0])).sum())
        now = time.perf_counter()
        h.log(f"superchunk {chunks[-1]}: {e / (now - t1):.1f} events/s")
        if now - t0 >= seconds:
            break
    _sync(h)
    secs = time.perf_counter() - t0
    return dict(seconds=secs, events=events, batches=batches, failed=failed,
                chunks=chunks, e2e={"train_events_per_s": events / secs})


def profile_first(h, st):
    """Run on to the epoch's first superchunk, the same work in every run,
    and run it under the profiler: (its trace, its train events of all
    seeds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    while st.chunk != 0:
        _advance(st)
    st.profiled_epoch = st.epoch
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if h.device.type == "cuda" else [])
    _sync(h)
    with profile(activities=acts) as prof:
        with record_function(trace.SEGMENT):
            events, _, _ = _advance(st)
            _sync(h)
    return trace.reduce(prof), events


def traced(h, st) -> Dict:
    """The marks superchunk, then the epoch's first superchunk under the
    profiler."""
    out: Dict = {}
    if h.device.type == "cuda":
        marks: list = []
        _advance(st, marks)
        _sync(h)
        gaps: Dict[str, List[float]] = {}
        for (_, a), (name, b) in zip(marks, marks[1:]):
            gaps.setdefault(name, []).append(a.elapsed_time(b))
        out["marks_ms"] = {k: float(np.mean(v)) for k, v in gaps.items()}
    out["trace"], _ = profile_first(h, st)
    return out


# ------------------------------------------------------------- the check

def _negs(st, epoch: int) -> np.ndarray:
    """[S, E_train] train negatives of every seed in ``epoch``."""
    return np.stack([streams.train_negatives(
        st.split.train, streams.neg_base(st.prog_seed + g), epoch)
        for g in range(st.s)])


def _batches(st, q_of, n: int, device) -> List[List[dict]]:
    """Per lane, the first ``n`` train batches with their queries."""
    tr, b = st.split.train, st.cfg.bs
    negs = _negs(st, 0)
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,
                                         device=device)
    out = []
    for g in range(st.s):
        lanes = []
        for i in range(n):
            sl = slice(i * b, (i + 1) * b)
            lanes.append(dict(
                src=as_t(tr.src[sl], torch.long), dst=as_t(tr.dst[sl],
                                                           torch.long),
                neg=as_t(negs[g, sl], torch.long),
                t=as_t(tr.t[sl].astype(np.float32), torch.float32),
                eidx=as_t(tr.eidx[sl], torch.long), q=q_of(g, i)))
        out.append(lanes)
    return out


def _queries(fields: Dict[str, np.ndarray], t: np.ndarray, device) -> Queries:
    """Extraction fields [b, 3, M, k] → queries [M, 3b, k] (src‖dst‖neg)."""
    tt = lambda x: np.ascontiguousarray(np.transpose(x, (2, 1, 0, 3)).reshape(
        x.shape[2], -1, x.shape[3]))
    t3 = np.tile(t.astype(np.float32), 3)
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
    return Queries(as_t(tt(fields["nbr"]), torch.long),
                   as_t(tt(fields["eidx"]), torch.long),
                   as_t(t3[None, :, None] - tt(fields["ts"]), torch.float32),
                   as_t(tt(fields["w"]), torch.float32))


def reference(st, prec: Prec, device) -> Dict:
    """What the plain reference works out for set-up's recorded stretch:
    the index after the first superchunk (or the first batches' BFS
    answers), and each seed's first steps."""
    cfg, tr, n = st.cfg, st.split.train, st.steps
    b = cfg.bs
    n_real = st.split.n_nodes + 1
    out: Dict = {}
    if cfg.tppr_strategy == "streaming":
        e0 = st.geo["chunk_events"][0]
        idx = santa.Index(n_real, cfg.alpha_list, cfg.beta_list, cfg.topk,
                          low=prec.low)
        negs = _negs(st, 0)[:, :e0]
        ext = idx.scan(tr.src[:e0], tr.dst[:e0], tr.t[:e0].astype(np.float32),
                       tr.eidx[:e0], negs, extract=True)
        out["index"] = idx
        out["answers"] = {f: ext[f][: n * b] for f in ("w", "nbr", "eidx")}
        t = tr.t.astype(np.float32)

        def q_of(g, i):
            sl = slice(i * b, (i + 1) * b)
            rows = [0, 1, 2 + g]
            return _queries({k: v[sl][:, rows] for k, v in ext.items()},
                            t[sl], device)

        # per seed and batch of the superchunk: the lazy update's rows
        first = work.first_batches(tr.src[:e0], tr.dst[:e0], b, n_real)
        out["lazy_rows"] = []
        for g in range(st.s):
            rows = [0, 1, 2 + g]
            nb = ext["nbr"][:, rows]
            w = ext["w"][:, rows]
            nbat = -(-e0 // b)
            out["lazy_rows"].append(work.lazy_rows_per_batch(
                (nb[i * b:(i + 1) * b] for i in range(nbat)),
                (w[i * b:(i + 1) * b] for i in range(nbat)),
                first, range(nbat)))
        out["lazy_events"] = e0
        out["live"] = (ext["w"][:, :2] > 0).sum(-1)      # [E, 2, M]
    else:
        adj = bfs.Adjacency(tr.src, tr.dst, tr.t, tr.eidx, n_real)
        negs = _negs(st, 0)
        answers = {}
        for g in range(st.s):
            for i in range(n):
                sl = slice(i * b, (i + 1) * b)
                roots = np.concatenate([tr.src[sl], tr.dst[sl], negs[g, sl]])
                answers[g, i] = bfs.pruned_topk(
                    adj, cfg.alpha_list, cfg.beta_list, roots,
                    np.tile(tr.t[sl].astype(np.float32), 3), cfg.n_degree,
                    cfg.n_layer, cfg.topk)
        out["bfs"] = answers
        as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)

        def q_of(g, i):
            a = answers[g, i]
            return Queries(as_t(a["nbr"], torch.long),
                           as_t(a["eidx"], torch.long),
                           as_t(a["dt"], torch.float32),
                           as_t(a["w"], torch.float32))

        first = work.first_batches(tr.src[: n * b], tr.dst[: n * b], b,
                                   n_real)
        out["lazy_rows"] = [work.lazy_rows_per_batch(
            (answers[g, i]["nbr"] for i in range(n)),
            (answers[g, i]["w"] for i in range(n)), first, range(n))
            for g in range(st.s)]
        out["lazy_events"] = n * b
    feats = st.feats.to(device)
    out["lanes"] = []
    for g, batches in enumerate(_batches(st, q_of, n, device)):
        p0 = st.params0 if st.s == 1 else lane(st.params0, g)
        p0 = {k: v.to(device) for k, v in p0.items()}
        gen = torch.Generator(device).manual_seed(st.prog_seed + g)
        steps, mem, final = train_steps(p0, prec, st.dims, cfg.lr, cfg.dropout,
                                        gen, n_real, feats, batches)
        out["lanes"].append(dict(losses=[s.loss for s in steps],
                                 grads=steps[0].grads, params=final,
                                 memory=mem.memory, params0=p0))
    return out


def program_side(st) -> Dict:
    """What the program produced, in the reference's shapes."""
    n_real = st.split.n_nodes + 1
    n_pad = st.cfg.n_nodes
    lanes = []
    for g in range(st.s):
        pick = (lambda d: d) if st.s == 1 else (lambda d: lane(d, g))
        lanes.append(dict(
            losses=list(st.losses[:, g] if st.s > 1 else st.losses),
            grads={k: v / 0.1 for k, v in pick(st.moments).items()},
            params=pick(st.params3),
            memory=st.memory2[g * n_pad: g * n_pad + n_real]))
    out: Dict = dict(lanes=lanes)
    if st.index0 is not None:
        out["index"] = santa.Index.from_packed(
            st.index0[:n_real], st.cfg.alpha_list, st.cfg.beta_list,
            st.cfg.topk)
        out["index_rest"] = float(np.abs(st.index0[n_real:]).sum())
        m, k = len(st.cfg.alpha_list), st.cfg.topk
        rows = st.rows.cpu().numpy()
        fields = rows[..., : 4 * m * k].reshape(rows.shape[:-1] + (m, 4, k))
        out["answers"] = dict(w=fields[..., 0, :],
                              nbr=fields[..., 1, :].astype(np.int64),
                              eidx=fields[..., 2, :].astype(np.int64))
    if st.bfs:
        out["bfs"] = {}
        b = st.cfg.bs
        for i, (nbr, eidx, dt, w) in enumerate(st.bfs):
            for g in range(st.s):
                cols = (slice(None) if st.s == 1 else
                        np.r_[0: 2 * b, (2 + g) * b: (3 + g) * b])
                np_ = lambda x: x.cpu().numpy()[:, cols]
                out["bfs"][g, i] = dict(nbr=np_(nbr), eidx=np_(eidx),
                                        w=np_(w))
    return out


def numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers: got (the program, or the control) against the
    reference."""
    out = dict(loss_gap=0.0, first_loss_gap=0.0, grad_gap=0.0,
               change_gap=0.0, memory_gap=0.0)
    for gl, rl in zip(got["lanes"], ref["lanes"]):
        out["loss_gap"] = max(out["loss_gap"],
                              checks.rel_gap(gl["losses"], rl["losses"]))
        out["first_loss_gap"] = max(out["first_loss_gap"], checks.rel_gap(
            gl["losses"][:1], rl["losses"][:1]))
        out["grad_gap"] = max(out["grad_gap"], checks.leaf_gap(
            {k: v.cpu() for k, v in gl["grads"].items()},
            {k: v.cpu() for k, v in rl["grads"].items()}))
        p0 = {k: v.cpu() for k, v in rl["params0"].items()}
        d_got = {k: gl["params"][k].cpu() - p0[k] for k in p0}
        d_ref = {k: rl["params"][k].cpu() - p0[k] for k in p0}
        out["change_gap"] = max(out["change_gap"], checks.leaf_gap(
            d_got, d_ref, checks.quiet_leaves(rl["grads"])))
        out["memory_gap"] = max(out["memory_gap"], checks.table_gap(
            gl["memory"].cpu(), rl["memory"].cpu()))
    if "index" in ref:
        out["index_gap"] = santa.gap(ref["index"], got["index"]) + float(
            got.get("index_rest", 0.0))
    if "answers" in got:
        out["answer_gap"] = bfs.gap(ref["answers"], got["answers"])
    if "bfs" in ref:
        out["bfs_gap"] = max(bfs.gap(ref["bfs"][key], got["bfs"][key])
                             for key in ref["bfs"])
    return out


def layer_context(h, st, ref: Dict, win: Dict, tr: Dict) -> Dict:
    """What the per-layer readers read."""
    cfg, dims = st.cfg, st.dims
    ctx = dict(trace=tr.get("trace"), marks_ms=tr.get("marks_ms"),
               window_s=win["seconds"],
               events_per_s=win["events"] / win["seconds"])
    # model FLOPs of the window: every seed's batches at the reference's
    # lazy rows per event
    per_event_lazy = np.mean([sum(r) for r in ref["lazy_rows"]]) / ref[
        "lazy_events"]
    tr_ev, b = st.split.train, cfg.bs
    first = work.first_batches(tr_ev.src, tr_ev.dst, b, st.split.n_nodes + 1)
    n_b = -(-len(tr_ev) // b)
    commit = [work.commit_rows(tr_ev.src[i * b:(i + 1) * b],
                               tr_ev.dst[i * b:(i + 1) * b], first, i)
              for i in range(n_b)]
    per_chunk = st.geo["per_chunk"]
    flops = 0.0
    for c in win["chunks"]:
        bats = range(c * per_chunk, min(n_b, (c + 1) * per_chunk))
        n_ev = st.geo["chunk_events"][c]
        flops += st.s * sum(
            work.train_batch_flops(b, dims.d, dims.t, dims.e, dims.m, dims.k,
                                   0.0, commit[i]) for i in bats)
        flops += st.s * 3 * work.gru_flops(per_event_lazy * n_ev, dims.msg,
                                           dims.d)
    ctx["model_flops"] = flops
    if cfg.tppr_strategy == "streaming" and "trace" in tr:
        e0 = st.geo["chunk_events"][0]
        negs = _negs(st, st.profiled_epoch)[:, :e0]
        ctx["santa_waves_work"] = work.index_work(
            tr_ev.src[:e0], tr_ev.dst[:e0], negs, np.ones(e0, bool), dims.m,
            dims.k, ref["live"])
    return ctx


def run(h) -> Dict:
    st = setup(h)
    setup_s = time.perf_counter() - h.t_start
    win = window(h, st, h.seconds)
    h.log("window closed")
    tr = traced(h, st) if h.trace else {}
    e2e = dict(win["e2e"], setup_s=setup_s)
    if not h.trace and DEVICE_TIME in h.reports("end_to_end"):
        got, events = profile_first(h, st)
        e2e[DEVICE_TIME] = 1e6 * got["busy_s"] / events
        h.log(f"profiled superchunk: {got['busy_s']!r} device s, "
              f"{events} events")
    peak = h.memory_peak()
    del st.trainer
    h.free()
    ref = reference(st, Prec(), h.ref_device)
    nums = numbers(program_side(st), ref)
    h.log("checked against the reference")
    return dict(e2e=e2e, numbers=nums, attempted=win["batches"],
                failed=win["failed"], memory_peak=peak,
                layer=layer_context(h, st, ref, win, tr) if h.trace else None)
