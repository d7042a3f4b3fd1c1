"""Readings that a cell's limits are set from, in one process: the compared
numbers of the program on many seeds, of the control (the reference in the
precision below the configuration's, put in the program's place) and, for
a training cell, of the program with a fault planted in it.

    python3 benchmark/calibrate.py --workload <name> --seeds 12
        [--first-seed N] [--control 3] [--faults 3] [--seconds 2]
    python3 benchmark/calibrate.py --workload <name> --summary-of FILE...

Prints one JSON line per reading: {"kind": "program" | "control" |
fault name, "seed": n, "numbers": {...}}; a training reading adds
``lanes``, each seed lane's numbers with the leaf that sets its gradient
and change gaps. Then one ``summary`` line per compared number, over
these readings (or over the reading lines of ``--summary-of``'s files):
the program's largest reading with its seed and lane, the control's and
each fault's least, and the limits that the rule allows: at least twice
the program's largest and at most half the least upper reading, the
control's where it reads three times the program's or more, a fault's
where it reads ten times or more. Serving cells run a short window of
``--seconds`` at the cell's load, so the check compares as many steps as
a run does. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402


@contextlib.contextmanager
def planted(name: str):
    """A fault planted in the program for the block's duration:
    ``half_batch`` (the loss's mean over half of each batch), ``answer``
    (one query answer altered where the index produces it)."""
    import torch

    import zebra_tpu_torch.train.loop as loop
    import zebra_tpu_torch.train.phase as phase

    undo = []
    if name == "half_batch":
        orig = phase._masked_mean

        def half(x, mask, count=None):
            n = x.shape[-1] // 2
            return orig(x[..., :n], mask[..., :n], count)

        phase._masked_mean = half
        undo.append((phase, "_masked_mean", orig))
    elif name == "answer":
        orig_w, orig_q = loop.wave_scan_chunk, phase.pruned_queries

        def waves(*a, **kw):
            state, rows = orig_w(*a, **kw)
            rows = rows.clone()
            # the fullest src row among the first batches
            e = int(rows[:600, 0].abs().sum(-1).argmax())
            rows[e, 0] = torch.roll(rows[e, 0], 1)
            return state, rows

        def queries(*a, **kw):
            q = orig_q(*a, **kw)
            w = q.w.clone()
            # the fullest query row: a row with no weight would roll to
            # itself
            r = int(w.sum((0, 2)).argmax())
            w[:, r] = torch.roll(w[:, r], 1, dims=-1)
            return q._replace(w=w)

        loop.wave_scan_chunk, phase.pruned_queries = waves, queries
        undo += [(loop, "wave_scan_chunk", orig_w),
                 (phase, "pruned_queries", orig_q)]
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)


def train_sides(h, kind: str):
    """(what the program, the control or a faulty program produced, what
    the reference works out) for set-up's recorded stretch."""
    from benchmark.loops import train
    from benchmark.reference.model import Prec

    if kind in ("program", "control"):
        st = train.setup(h, warm=False)
    else:
        with planted(kind):
            st = train.setup(h, warm=False)
    del st.trainer
    h.free()
    ref = train.reference(st, Prec(), h.ref_device)
    if kind == "control":
        low = train.reference(st, Prec(low=True), h.ref_device)
        got = dict(lanes=low["lanes"], **{
            k: low[k] for k in ("index", "answers", "bfs") if k in low})
    else:
        got = train.program_side(st)
    return got, ref


def train_readings(h, kind: str):
    from benchmark.loops import train

    return train.numbers(*train_sides(h, kind))


def lane_readings(got, ref) -> list:
    """Each seed lane's numbers, each step's loss gap, and the leaves that
    set its gradient and change gaps."""
    from benchmark import checks
    from benchmark.loops import train

    out = []
    for gl, rl in zip(got["lanes"], ref["lanes"]):
        nums = train.numbers(dict(lanes=[gl]), dict(lanes=[rl]))
        grads = checks.leaf_gaps({k: v.cpu() for k, v in gl["grads"].items()},
                                 {k: v.cpu() for k, v in rl["grads"].items()})
        p0 = {k: v.cpu() for k, v in rl["params0"].items()}
        change = checks.leaf_gaps(
            {k: gl["params"][k].cpu() - p0[k] for k in p0},
            {k: rl["params"][k].cpu() - p0[k] for k in p0},
            checks.quiet_leaves(rl["grads"]))
        out.append(dict(nums, grad_leaf=max(grads, key=grads.get),
                        change_leaf=max(change, key=change.get),
                        loss_steps=[checks.rel_gap([g], [r]) for g, r in
                                    zip(gl["losses"], rl["losses"])]))
    return out


def summary(readings: list, limits: dict) -> list:
    """Per compared number: the program's largest reading (seed, lane),
    the control's and each fault's least, and the limits the rule
    allows."""
    out = []
    for name, limit in limits.items():
        by = {}
        for r in readings:
            v = r["numbers"].get(name)
            if v is not None:
                by.setdefault(r["kind"], []).append((v, r))
        prog = by.pop("program", [])
        if not prog:
            continue
        top, r = max(prog, key=lambda x: x[0])
        lanes = [ln.get(name, -1.0) for ln in r.get("lanes", [])]
        line = dict(summary=name, program_n=len(prog), program_max=top,
                    seed=r["seed"],
                    lane=int(np.argmax(lanes)) if lanes else None,
                    limit=limit)
        upper = []
        for kind, vals in by.items():
            least = min(v for v, _ in vals)
            line[f"{kind}_min"] = least
            if least > 0 and least >= (3 if kind == "control" else 10) * top:
                upper.append(least)
        line["allowed"] = [2 * top, min(upper) / 2 if upper else None]
        line["within"] = bool(limit >= 2 * top and (
            not upper or limit <= min(upper) / 2))
        out.append(line)
    return out


def serve_readings(h, kind: str, seconds: float):
    from benchmark.loops import serve

    st = serve.setup(h)
    serve.window(h, st, seconds)
    st.base = (st.base[0].cpu(), [x.cpu() for x in st.base[1]])
    st.after = {j: (s[0].cpu(), [x.cpu() for x in s[1]])
                for j, s in st.after.items()}
    del st.pred
    h.free()
    return serve.numbers(st, h.ref_device, control=kind == "control")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--summary-of", nargs="+", type=Path, default=None)
    args = p.parse_args(argv)
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in spec["workloads"] if c["name"] == args.workload)
    limits_file = run.BENCH / "limits" / f"{args.workload}.json"
    limits = json.loads(limits_file.read_text())
    if args.summary_of:
        readings = [json.loads(ln) for f in args.summary_of
                    for ln in f.read_text().splitlines()
                    if ln.startswith('{"kind"')]
        for line in summary(readings, limits):
            print(json.dumps(line), flush=True)
        return 0
    plan = [("program", s) for s in range(args.seeds)]
    plan += [("control", s) for s in range(args.control)]
    h0 = run.Harness(spec, cell, 0, args.seconds, False, args.device)
    if h0.traffic["loop"] == "train":
        plan += [(f, s) for f in ("half_batch", "answer")
                 for s in range(args.faults)]
    from benchmark.loops import train

    readings = []
    for kind, s in plan:
        seed = args.first_seed + 7919 * s
        h = run.Harness(spec, cell, seed, args.seconds, False, args.device,
                        t_start=time.perf_counter())
        line = dict(kind=kind, seed=seed)
        if h.traffic["loop"] == "train":
            got, ref = train_sides(h, kind)
            line.update(numbers=train.numbers(got, ref),
                        lanes=lane_readings(got, ref))
            del got, ref
        else:
            line.update(numbers=serve_readings(h, kind, args.seconds))
        line["seconds"] = time.perf_counter() - h.t_start
        readings.append(line)
        print(json.dumps(line), flush=True)
    for line in summary(readings, limits):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
