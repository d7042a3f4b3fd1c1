"""The serving loop of a cell: a closed loop of ``LinkPredictor.score`` then
``LinkPredictor.observe``, one writer ingesting in stream order.

The stream is the configuration's published history followed by a
continuation of the same generator over the same nodes. Set-up builds a
predictor with zeroed memory and an empty index from the seed's weights,
ingests the history by ``observe`` in batches of ``batch`` events, warms
``score`` at the step's shape, and keeps a copy of the post-history state.
Each step of the window scores ``batch`` true pairs of the next events and
the same sources against destinations drawn uniformly from the seed, at
the events' times, then observes those events. The continuation holds
``round_events`` events; when the window has used them all, the
post-history state is copied back in place and the continuation runs
again, so no event enters state that already holds it.

The check follows sampled steps of the first round from the program's own
state before each (the state is copied aside around them during the
window), and checks the set-up's history ingest, the start of that state,
against the reference's own replay from empty.

Traffic keys: ``batch``, ``round_events``, ``sampled_steps``,
``sample_from`` (the first steps the sample is drawn from),
``profiled_steps``."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import checks, program, streams, trace, work
from benchmark.reference import santa
from benchmark.reference.model import Memory, Prec, Queries, score, time_basis
from benchmark.weights import edge_features, make_params


class State:
    """What set-up made."""


def _state(pred):
    return (pred.index_state.data.detach().clone(),
            [x.detach().clone() for x in pred.mem])


def _restore(pred, saved) -> None:
    pred.index_state.data.copy_(saved[0])
    for x, s in zip(pred.mem, saved[1]):
        x.copy_(s)


def setup(h) -> State:
    from zebra_tpu_torch.index.streaming import init_tppr_state
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
    index = init_tppr_state(cfg.n_tppr, n, cfg.topk, device=h.device)
    st.pred = LinkPredictor(cfg, program.param_tree(st.params), mem, index,
                            st.feats, device=h.device)
    h.log("stream made, predictor built")
    hs = st.hist
    for i in range(0, n_hist, b):
        sl = slice(i, i + b)
        st.pred.observe(hs.src[sl], hs.dst[sl], hs.t[sl].astype(np.float32),
                        hs.eidx[sl])
    h.log("history ingested")
    for j in range(3):
        st.pred.score(*_candidates(st, j))
    st.base = _state(st.pred)
    k = int(tr["sampled_steps"])
    pool = min(int(tr["sample_from"]), st.steps_per_round)
    st.sampled = sorted(rng.choice(pool, size=k, replace=False).tolist())
    _sync(h)
    return st


def _sync(h) -> None:
    if h.device.type == "cuda":
        torch.cuda.synchronize(h.device)


def _candidates(st, j: int):
    c, sl = st.cont, slice(j * st.b, (j + 1) * st.b)
    return (np.concatenate([c["src"][sl], c["src"][sl]]),
            np.concatenate([c["dst"][sl], c["neg"][sl]]),
            np.concatenate([c["t"][sl], c["t"][sl]]))


def _events(st, j: int):
    c, sl = st.cont, slice(j * st.b, (j + 1) * st.b)
    return c["src"][sl], c["dst"][sl], c["t"][sl], c["eidx"][sl]


def window(h, st, seconds: float) -> Dict:
    pred, spr = st.pred, st.steps_per_round
    keep = set(st.sampled) | {j - 1 for j in st.sampled if j > 0}
    st.scores, st.after = {}, {}
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
        cand = _candidates(st, j)
        a = time.perf_counter()
        p = pred.score(*cand)
        lat.append(time.perf_counter() - a)
        if p.shape != (2 * st.b,) or not np.isfinite(p).all():
            failed += 1
        pred.observe(*_events(st, j))
        if step < spr:
            if step in st.sampled:
                st.scores[step] = p
            if step in keep:
                st.after[step] = _state(pred)
        step += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(h)
    secs = time.perf_counter() - t0
    st.next_step = step
    return dict(seconds=secs, steps=step, failed=failed, e2e=dict(
        serve_events_per_s=step * st.b / secs,
        score_ms_p95=1e3 * float(np.percentile(lat, 95))))


def traced(h, st) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    pred, spr = st.pred, st.steps_per_round
    n = int(h.traffic["profiled_steps"])
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if h.device.type == "cuda" else [])
    calls = []
    _sync(h)
    with profile(activities=acts) as prof:
        with record_function(trace.SEGMENT):
            for step in range(st.next_step, st.next_step + n):
                j = step % spr
                if j == 0:
                    _restore(pred, st.base)
                pred.score(*_candidates(st, j))
                pred.observe(*_events(st, j))
                calls.append(j)
            _sync(h)
    m, k = st.dims.m, st.dims.k
    nbytes = ops = 0.0
    for j in calls:
        src, dst = _events(st, j)[:2]
        bb, oo = work.index_work(src, dst, None, np.ones(len(src), bool), m, k)
        nbytes, ops = nbytes + bb, ops + oo
    return dict(trace=trace.reduce(prof), santa_scan_work=(nbytes, ops))


# ------------------------------------------------------------- the check

def _index(st, packed: torch.Tensor, low: bool = False) -> santa.Index:
    cfg = st.cfg
    return santa.Index.from_packed(packed.cpu().numpy(), cfg.alpha_list,
                                   cfg.beta_list, cfg.topk, low)


def _memory(st, saved, device) -> Memory:
    """The reference's memory holding a copy of the program's tables."""
    memory, last, msgs, msg_ts, _ = (x.to(device) for x in saved[1])
    mem = Memory(st.n, st.dims, device)
    mem.memory = memory.float().clone()
    mem.last = last.float().clone()
    mem.msg = msgs[:, :-1].float().clone()
    mem.flag = msgs[:, -1] != 0
    mem.msg_ts = msg_ts.float().clone()
    return mem


def _queries(idx: santa.Index, nodes: np.ndarray, t: np.ndarray,
             device) -> Queries:
    w, nbr, eidx, ts = idx.rows(nodes)                  # [M, Q, k]
    as_t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                         device=device)
    return Queries(as_t(nbr, torch.long), as_t(eidx, torch.long),
                   as_t(t[None, :, None] - ts, torch.float32),
                   as_t(w, torch.float32))


def _step(st, prec: Prec, idx: santa.Index, mem: Memory, j: int, device):
    """One window step from a state: (the candidates' probabilities, then
    the index and memory after the observe, in place)."""
    cs, cd, ct = _candidates(st, j)
    feats, basis = st.feats.to(device), time_basis(st.dims.t, device)
    params = {k: v.to(device) for k, v in st.params.items()}
    q = _queries(idx, np.concatenate([cs, cd]), np.concatenate([ct, ct]),
                 device)
    as_l = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
    p = score(params, prec, st.dims, mem, feats, basis, q, as_l(cs),
              as_l(cd)).cpu().numpy()
    src, dst, t, e = _events(st, j)
    idx.scan(src, dst, t, e)
    with torch.no_grad():
        mem.observe(params, prec, feats, basis, as_l(src), as_l(dst),
                    torch.as_tensor(t, device=device), as_l(e))
    return p


def replay(st, prec: Prec, device):
    """The reference's own ingest of the history from empty."""
    cfg, hs = st.cfg, st.hist
    idx = santa.Index(st.n, cfg.alpha_list, cfg.beta_list, cfg.topk,
                      low=prec.low)
    idx.scan(hs.src, hs.dst, hs.t.astype(np.float32), hs.eidx)
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
    return idx, mem


def _before(st, j: int):
    return st.base if j == 0 else st.after.get(j - 1)


def numbers(st, device, control: bool = False) -> Dict[str, float]:
    """The compared numbers of the program's recorded outputs (or, with
    ``control``, of the control put in its place) against the reference."""
    ref_idx, ref_mem = replay(st, Prec(), device)
    if control:
        got_idx, got_mem = replay(st, Prec(low=True), device)
        got_mem_t = got_mem.memory
    else:
        got_idx = _index(st, st.base[0])
        got_mem_t = st.base[1][0].to(device).float()
    out = dict(index_gap_start=santa.gap(ref_idx, got_idx),
               memory_gap_start=checks.table_gap(got_mem_t.cpu(),
                                                 ref_mem.memory.cpu()),
               score_gap=0.0, index_gap=0.0, memory_gap=0.0)
    for j in st.sampled:
        pre, post = _before(st, j), st.after.get(j)
        if pre is None or post is None or j not in st.scores:
            return dict(out, score_gap=float("inf"), index_gap=float("inf"),
                        memory_gap=float("inf"))
        r_idx, r_mem = _index(st, pre[0]), _memory(st, pre, device)
        p_ref = _step(st, Prec(), r_idx, r_mem, j, device)
        if control:
            c_idx = _index(st, pre[0], low=True)
            c_mem = _memory(st, pre, device)
            p_got = _step(st, Prec(low=True), c_idx, c_mem, j, device)
            g_idx, g_mem = c_idx, c_mem.memory
        else:
            p_got = st.scores[j]
            g_idx, g_mem = _index(st, post[0]), post[1][0].to(device).float()
        out["score_gap"] = max(out["score_gap"], float(np.max(np.abs(
            np.asarray(p_got, np.float64) - p_ref))))
        out["index_gap"] = max(out["index_gap"], santa.gap(r_idx, g_idx))
        out["memory_gap"] = max(out["memory_gap"], checks.table_gap(
            g_mem.cpu(), r_mem.memory.cpu()))
    return out


def layer_context(st, win: Dict, tr: Dict) -> Dict:
    dims, b = st.dims, st.b
    flops = 0.0
    spr = st.steps_per_round
    per_step = [work.serve_step_flops(
        2 * b, dims.d, dims.t, dims.e, dims.m, dims.k,
        work.commit_rows(*_events(st, j)[:2], None, 0)) for j in range(spr)]
    full, rest = divmod(win["steps"], spr)
    flops = full * sum(per_step) + sum(per_step[:rest])
    return dict(trace=tr["trace"], santa_scan_work=tr["santa_scan_work"],
                model_flops=flops, window_s=win["seconds"])


def run(h) -> Dict:
    st = setup(h)
    setup_s = time.perf_counter() - h.t_start
    win = window(h, st, h.seconds)
    h.log("window closed")
    tr = traced(h, st) if h.trace else {}
    peak = h.memory_peak()
    st.base = (st.base[0].cpu(), [x.cpu() for x in st.base[1]])
    st.after = {j: (s[0].cpu(), [x.cpu() for x in s[1]])
                for j, s in st.after.items()}
    del st.pred
    h.free()
    nums = numbers(st, h.ref_device)
    h.log("checked against the reference")
    return dict(e2e=dict(win["e2e"], setup_s=setup_s), numbers=nums,
                attempted=win["steps"], failed=win["failed"],
                memory_peak=peak,
                layer=layer_context(st, win, tr) if h.trace else None)
