"""The serving loop of a pruning cell: a closed loop of
``LinkPredictor.score`` then ``LinkPredictor.observe``, one writer
ingesting in stream order, as ``serve.py`` runs the streaming cell, with
the adjacency index folded on the host at every ``rebuild_every`` observed
events (``LinkPredictor.flush_index``).

The stream is the configuration's published history followed by a
continuation of the same generator over the same nodes. Set-up builds a
predictor with zeroed memory and an empty adjacency index from the seed's
weights, ingests the history by ``observe`` in batches of ``batch``
events with the fold held back (the observes read no index, so the state
is what folding at every call leaves), folds the history once, warms
``score`` at the step's shape, and keeps the post-history state. Each step
of the window scores ``batch`` true pairs of the next events and the same
sources against destinations drawn uniformly from the seed, at the
events' times (one BFS over the index), then observes those events (a
fold, then the eval protocol). The continuation holds ``round_events``
events; when the window has used them all, the post-history memory and
index are put back and the continuation runs again.

The check holds the set-up's memory against the reference's own replay of
the history from empty, then follows sampled steps of the first round
from the program's state before each: the BFS answers over the history
and the continuation so far (``reference/bfs.py``; ``bfs_gap``), the
scores and the memory after the observe (``reference/model.py``).

Traffic keys: ``batch``, ``round_events``, ``sampled_steps``,
``sample_from``, ``profiled_steps``, ``rebuild_every``."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import checks, program, spans, streams, trace, work
from benchmark.loops import serve
from benchmark.reference import bfs
from benchmark.reference.model import Memory, Prec, Queries, score, time_basis
from benchmark.weights import edge_features, make_params


class State:
    """What set-up made."""


def _state(pred):
    """The predictor's memory tables and adjacency index (never changed in
    place: a fold builds a new one) with the events it holds."""
    return ((pred.nbr_index, pred._events),
            [x.detach().clone() for x in pred.mem])


def _restore(pred, saved) -> None:
    pred.nbr_index, pred._events = saved[0]
    pred._pending, pred._pending_n = [], 0
    for x, s in zip(pred.mem, saved[1]):
        x.copy_(s)


def setup(h) -> State:
    from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
    from zebra_tpu_torch.models.memory import init_memory
    from zebra_tpu_torch.serve import LinkPredictor

    st = State()
    conf, tr = h.config, h.traffic
    stream_seed, weight_seed, prog_seed, traffic_seed = streams.sub_seeds(
        h.seed)
    sc = conf["stream"]
    b = st.b = int(tr["batch"])
    n_hist, n_cont = sc["n_events"], int(tr["round_events"])
    ev = streams.synthetic_events(n_hist + n_cont, sc["n_users"],
                                  sc["n_items"], int(stream_seed),
                                  sc.get("skew", 0.9))
    st.hist = ev.take(slice(0, n_hist))
    cont = ev.take(slice(n_hist, n_hist + n_cont))
    rng = np.random.RandomState(int(traffic_seed))
    lo = sc["n_users"] + 1
    st.cont = dict(src=cont.src, dst=cont.dst, t=cont.t.astype(np.float32),
                   eidx=cont.eidx,
                   neg=rng.randint(lo, lo + sc["n_items"], n_cont))
    st.steps_per_round = n_cont // b
    n = st.n = sc["n_users"] + sc["n_items"] + 1
    st.feats = edge_features(n_hist + n_cont + 1, sc["edge_dim"],
                             int(weight_seed), h.device)
    cfg = program.config(conf["model"], int(prog_seed), n_nodes=n,
                         n_edges=n_hist + n_cont + 1,
                         edge_dim=sc["edge_dim"], real_edge_feats=True)
    st.cfg, st.dims = cfg, program.dims(cfg, sc["edge_dim"])
    st.params = make_params(st.dims, int(weight_seed), h.device)
    mem = init_memory(n, cfg.memory_dim, cfg.msg_table_dim,
                      torch.bfloat16, torch.bfloat16, device=h.device)
    none = np.zeros(0, np.int64)
    empty = (none, none, np.zeros(0, np.float64), none)
    st.pred = LinkPredictor(
        cfg, program.param_tree(st.params), mem, None, st.feats,
        nbr_index=build_neighbor_index(*empty, n, h.device), events=empty,
        rebuild_every=n_hist + 1, device=h.device, internal_ids=True)
    h.log("stream made, predictor built")
    hs = st.hist
    for i in range(0, n_hist, b):
        sl = slice(i, i + b)
        st.pred.observe(hs.src[sl], hs.dst[sl], hs.t[sl].astype(np.float32),
                        hs.eidx[sl])
    st.pred.flush_index()
    st.pred.rebuild_every = int(tr["rebuild_every"])
    h.log("history ingested and folded")
    for j in range(3):
        st.pred.score(*serve._candidates(st, j))
    st.base = _state(st.pred)
    k = int(tr["sampled_steps"])
    pool = min(int(tr["sample_from"]), st.steps_per_round)
    st.sampled = sorted(rng.choice(pool, size=k, replace=False).tolist())
    serve._sync(h)
    return st


def window(h, st, seconds: float) -> Dict:
    """The closed loop; the sampled steps of the first round keep their
    scores, their BFS answers and the state after them (and before)."""
    import zebra_tpu_torch.serve as serving

    orig, last = serving.pruned_queries, {}

    def queries(*a, **kw):
        last["q"] = orig(*a, **kw)
        return last["q"]

    serving.pruned_queries = queries
    try:
        return _window(h, st, seconds, last)
    finally:
        serving.pruned_queries = orig


def _window(h, st, seconds: float, last: Dict) -> Dict:
    pred, spr = st.pred, st.steps_per_round
    keep = set(st.sampled) | {j - 1 for j in st.sampled if j > 0}
    st.scores, st.answers, st.after = {}, {}, {}
    lat: List[float] = []
    step = failed = 0
    t0 = t1 = time.perf_counter()
    while True:
        j = step % spr
        if j == 0 and step:
            now = time.perf_counter()
            h.log(f"round: {spr * st.b / (now - t1):.1f} events/s")
            _restore(pred, st.base)
            t1 = now
        cand = serve._candidates(st, j)
        a = time.perf_counter()
        p = pred.score(*cand)
        lat.append(time.perf_counter() - a)
        if p.shape != (2 * st.b,) or not np.isfinite(p).all():
            failed += 1
        pred.observe(*serve._events(st, j))
        if step < spr:
            if step in st.sampled:
                st.scores[step] = p
                st.answers[step] = {f: getattr(last["q"], f).cpu().numpy()
                                    for f in ("w", "nbr", "eidx")}
            if step in keep:
                st.after[step] = _state(pred)
        step += 1
        if time.perf_counter() - t0 >= seconds:
            break
    serve._sync(h)
    secs = time.perf_counter() - t0
    st.next_step = step
    h.log(f"window: {step} steps")
    return dict(seconds=secs, steps=step, failed=failed, e2e=dict(
        serve_events_per_s=step * st.b / secs,
        score_ms_p95=1e3 * float(np.percentile(lat, 95))))


def traced(h, st) -> Dict:
    """``profiled_steps`` further steps under the profiler: the trace and
    the span table."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pred, spr = st.pred, st.steps_per_round
    n = int(h.traffic["profiled_steps"])
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if h.device.type == "cuda" else [])
    serve._sync(h)
    with profile(activities=acts) as prof:
        with record_function(trace.SEGMENT):
            for step in range(st.next_step, st.next_step + n):
                j = step % spr
                if j == 0:
                    _restore(pred, st.base)
                pred.score(*serve._candidates(st, j))
                pred.observe(*serve._events(st, j))
            serve._sync(h)
    out = dict(trace=trace.reduce(prof), spans=spans.reduce(prof))
    for name, row in sorted(out["spans"].items()):
        h.log(f"span {name}: {row['calls']} calls, "
              f"{1e3 * row['host_s'] / n:.4f} host ms, "
              f"{1e3 * row['device_s'] / n:.4f} device ms, "
              f"{1e3 * row['idle_s'] / n:.4f} idle ms a step")
    return out


# ------------------------------------------------------------- the check

def replay(st, prec: Prec, device) -> Memory:
    """The reference's own ingest of the history's memory from empty."""
    hs = st.hist
    mem = Memory(st.n, st.dims, device)
    feats, basis = st.feats.to(device), time_basis(st.dims.t, device)
    params = {k: v.to(device) for k, v in st.params.items()}
    as_l = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
    with torch.no_grad():
        for i in range(0, len(hs), st.b):
            sl = slice(i, i + st.b)
            mem.observe(params, prec, feats, basis, as_l(hs.src[sl]),
                        as_l(hs.dst[sl]),
                        torch.as_tensor(hs.t[sl].astype(np.float32),
                                        device=device), as_l(hs.eidx[sl]))
    return mem


def _step(st, prec: Prec, mem: Memory, j: int, device):
    """One window step from a memory state: (the candidates' BFS answers
    over the history and the continuation before step ``j``, their
    probabilities), then the memory after the observe, in place."""
    cfg, hs, c = st.cfg, st.hist, st.cont
    upto = j * st.b
    cat = lambda a, k: np.concatenate([a, c[k][:upto]])
    adj = bfs.Adjacency(cat(hs.src, "src"), cat(hs.dst, "dst"),
                        cat(hs.t.astype(np.float32), "t"),
                        cat(hs.eidx, "eidx"), st.n)
    cs, cd, ct = serve._candidates(st, j)
    a = bfs.pruned_topk(adj, cfg.alpha_list, cfg.beta_list,
                        np.concatenate([cs, cd]), np.concatenate([ct, ct]),
                        cfg.n_degree, cfg.n_layer, cfg.topk)
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
    q = Queries(as_t(a["nbr"], torch.long), as_t(a["eidx"], torch.long),
                as_t(a["dt"], torch.float32), as_t(a["w"], torch.float32))
    feats, basis = st.feats.to(device), time_basis(st.dims.t, device)
    params = {k: v.to(device) for k, v in st.params.items()}
    as_l = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
    p = score(params, prec, st.dims, mem, feats, basis, q, as_l(cs),
              as_l(cd)).cpu().numpy()
    src, dst, t, e = serve._events(st, j)
    with torch.no_grad():
        mem.observe(params, prec, feats, basis, as_l(src), as_l(dst),
                    torch.as_tensor(t, device=device), as_l(e))
    return a, p


def numbers(st, device, control: bool = False) -> Dict[str, float]:
    """The compared numbers of the program's recorded outputs (or, with
    ``control``, of the control put in its place) against the reference."""
    ref = replay(st, Prec(), device)
    got = (replay(st, Prec(low=True), device).memory if control
           else st.base[1][0].to(device).float())
    out = dict(memory_gap_start=checks.table_gap(got.cpu(),
                                                 ref.memory.cpu()),
               score_gap=0.0, memory_gap=0.0, bfs_gap=0.0)
    for j in st.sampled:
        pre = st.base if j == 0 else st.after.get(j - 1)
        post = st.after.get(j)
        if pre is None or post is None or j not in st.scores:
            return dict(out, score_gap=float("inf"),
                        memory_gap=float("inf"), bfs_gap=float("inf"))
        r_mem = serve._memory(st, pre, device)
        a_ref, p_ref = _step(st, Prec(), r_mem, j, device)
        if control:
            c_mem = serve._memory(st, pre, device)
            a_got, p_got = _step(st, Prec(low=True), c_mem, j, device)
            g_mem = c_mem.memory
        else:
            a_got, p_got = st.answers[j], st.scores[j]
            g_mem = post[1][0].to(device).float()
        out["bfs_gap"] = max(out["bfs_gap"], bfs.gap(a_ref, a_got))
        out["score_gap"] = max(out["score_gap"], float(np.max(np.abs(
            np.asarray(p_got, np.float64) - p_ref))))
        out["memory_gap"] = max(out["memory_gap"], checks.table_gap(
            g_mem.cpu(), r_mem.memory.cpu()))
    return out


def model_flops(st, steps: int) -> float:
    """The model FLOPs of the window's ``steps`` (``work.serve_step_flops``:
    the towers and head over the 400 candidates' rows, the GRU over the
    observe's commits), as ``serve.py`` counts the streaming cell's."""
    dims, b, spr = st.dims, st.b, st.steps_per_round
    per_step = [work.serve_step_flops(
        2 * b, dims.d, dims.t, dims.e, dims.m, dims.k,
        work.commit_rows(*serve._events(st, j)[:2], None, 0))
        for j in range(spr)]
    full, rest = divmod(steps, spr)
    return float(full * sum(per_step) + sum(per_step[:rest]))


def run(h) -> Dict:
    st = setup(h)
    setup_s = time.perf_counter() - h.t_start
    win = window(h, st, h.seconds)
    h.log("window closed")
    tr = traced(h, st) if h.trace else {}
    peak = h.memory_peak()
    st.base = (None, [x.cpu() for x in st.base[1]])
    st.after = {j: (None, [x.cpu() for x in s[1]])
                for j, s in st.after.items()}
    del st.pred
    h.free()
    nums = numbers(st, h.ref_device)
    h.log("checked against the reference")
    return dict(e2e=dict(win["e2e"], setup_s=setup_s), numbers=nums,
                attempted=win["steps"], failed=win["failed"],
                memory_peak=peak,
                layer=dict(tr, window_s=win["seconds"],
                           model_flops=model_flops(st, win["steps"]))
                if h.trace else None)
