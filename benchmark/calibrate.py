"""Readings that a cell's limits are set from, in one process: the compared
numbers of the program on many seeds, of the control (the reference in the
precision below the configuration's, put in the program's place) and, for
a training cell, of the program with a fault planted in it.

    python3 benchmark/calibrate.py --workload <name> --seeds 12
        [--first-seed N] [--control 3] [--faults 3] [--seconds 2]

Prints one JSON line per reading: {"kind": "program" | "control" |
fault name, "seed": n, "numbers": {...}}. Serving cells run a short window
of ``--seconds`` at the cell's load, so the check compares as many steps as
a run does. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

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
            w[:, 0] = torch.roll(w[:, 0], 1, dims=-1)
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


def train_readings(h, kind: str):
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
        got = dict(lanes=low["lanes"], **{k: low[k] for k in ("index", "bfs")
                                          if k in low})
    else:
        got = train.program_side(st)
    return train.numbers(got, ref)


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
    args = p.parse_args(argv)
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in spec["workloads"] if c["name"] == args.workload)
    plan = [("program", s) for s in range(args.seeds)]
    plan += [("control", s) for s in range(args.control)]
    h0 = run.Harness(spec, cell, 0, args.seconds, False, args.device)
    if h0.traffic["loop"] == "train":
        plan += [(f, s) for f in ("half_batch", "answer")
                 for s in range(args.faults)]
    for kind, s in plan:
        seed = args.first_seed + 7919 * s
        h = run.Harness(spec, cell, seed, args.seconds, False, args.device,
                        t_start=time.perf_counter())
        if h.traffic["loop"] == "train":
            nums = train_readings(h, kind)
        else:
            nums = serve_readings(h, kind, args.seconds)
        print(json.dumps(dict(kind=kind, seed=seed, numbers=nums,
                              seconds=time.perf_counter() - h.t_start)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
