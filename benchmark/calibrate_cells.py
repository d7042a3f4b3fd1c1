"""Readings that the limits of the cells whose loops ``calibrate.py`` does
not run are set from, in one process, as ``calibrate.py`` takes them for
the others: the compared numbers of the program on many seeds, of the
control (the reference one precision down put in the program's place) and
of the program with a fault planted in it. A recursive-tower train cell
(loop ``train_tower``): ``half_batch`` (``calibrate.planted``) and ``hop``
(each root's newest neighbour dropped from the hop tree). A pruning
serving cell (loop ``serve_pruning``): ``stale`` (no observed event folded
into the adjacency index) and ``half_batch`` (each observe ingests half
its events), over a short window of ``--seconds``.

    python3 benchmark/calibrate_cells.py --workload <name> --seeds 24
        [--first-seed N] [--control 3] [--faults 3] [--seconds 20]
    python3 benchmark/calibrate_cells.py --workload <name> --summary-of FILE...

Prints one JSON line per reading, with the verdict of the cell's limits
(``checks.verdict``), then ``calibrate.summary``'s line per compared
number. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import calibrate, run  # noqa: E402
from benchmark.checks import verdict  # noqa: E402

FAULTS = {"train_tower": ("half_batch", "hop"),
          "serve_pruning": ("stale", "half_batch")}


@contextlib.contextmanager
def planted(name: str):
    """A fault planted in the program for the block's duration."""
    if name != "hop":
        with calibrate.planted(name):
            yield
        return
    import zebra_tpu_torch.models.embedding as emb

    orig_tree, orig_find = emb.hop_tree, emb.most_recent_neighbors

    def hop_tree(*a, **kw):
        first = [True]

        def find(index, nodes, cuts, n):
            if not first[0]:
                return orig_find(index, nodes, cuts, n)
            # the roots' hop: one more neighbour, the newest dropped
            first[0] = False
            return tuple(x[:, 1:] if x.dim() == 2 else x
                         for x in orig_find(index, nodes, cuts, n + 1))

        emb.most_recent_neighbors = find
        try:
            return orig_tree(*a, **kw)
        finally:
            emb.most_recent_neighbors = orig_find

    emb.hop_tree = hop_tree
    try:
        yield
    finally:
        emb.hop_tree = orig_tree


@contextlib.contextmanager
def serve_fault(name: str):
    """A fault planted in the serving program for the block's duration."""
    from zebra_tpu_torch.serve import LinkPredictor

    attr = "flush_index" if name == "stale" else "observe"
    orig = getattr(LinkPredictor, attr)
    if name == "stale":
        fn = lambda self: None
    elif name == "half_batch":
        def fn(self, src, dst, t, eidx):
            n = len(src) // 2
            return orig(self, src[:n], dst[:n], t[:n], eidx[:n])
    else:
        raise ValueError(name)
    setattr(LinkPredictor, attr, fn)
    try:
        yield
    finally:
        setattr(LinkPredictor, attr, orig)


def serve_readings(h, kind: str, seconds: float):
    """The serving cell's numbers; a fault is planted after set-up, in the
    window the check follows."""
    from benchmark.loops import serve_pruning

    st = serve_pruning.setup(h)
    ctx = (contextlib.nullcontext() if kind in ("program", "control")
           else serve_fault(kind))
    with ctx:
        serve_pruning.window(h, st, seconds)
    st.base = (None, [x.cpu() for x in st.base[1]])
    st.after = {j: (None, [x.cpu() for x in s[1]])
                for j, s in st.after.items()}
    del st.pred
    h.free()
    return serve_pruning.numbers(st, h.ref_device,
                                 control=kind == "control")


def sides(h, kind: str):
    """(what the program, the control or a faulty program produced, what
    the reference works out)."""
    from benchmark.loops import train_tower
    from benchmark.reference.tgn import Prec

    ctx = (contextlib.nullcontext() if kind in ("program", "control")
           else planted(kind))
    with ctx:
        st = train_tower.setup(h, warm=False)
    del st.trainer
    h.free()
    ref = train_tower.reference(st, Prec(), h.ref_device)
    if kind == "control":
        low = train_tower.reference(st, Prec(low=True), h.ref_device)
        return low, ref
    return train_tower.program_side(st), ref


def readings(h, kind: str):
    from benchmark.loops import train_tower

    return train_tower.numbers(*sides(h, kind))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=24)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--summary-of", nargs="+", type=Path, default=None)
    args = p.parse_args(argv)
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in spec["workloads"] if c["name"] == args.workload)
    limits = json.loads((run.BENCH / "limits"
                         / f"{args.workload}.json").read_text())
    if args.summary_of:
        lines = [json.loads(ln) for f in args.summary_of
                 for ln in f.read_text().splitlines()
                 if ln.startswith('{"kind"')]
    else:
        plan = [("program", s) for s in range(args.seeds)]
        plan += [("control", s) for s in range(args.control)]
        h0 = run.Harness(spec, cell, 0, args.seconds, False, args.device)
        loop = h0.traffic["loop"]
        plan += [(f, s) for f in FAULTS[loop] for s in range(args.faults)]
        lines = []
        for kind, s in plan:
            seed = args.first_seed + 7919 * s
            h = run.Harness(spec, cell, seed, args.seconds, False,
                            args.device, t_start=time.perf_counter())
            nums = (readings(h, kind) if loop == "train_tower"
                    else serve_readings(h, kind, args.seconds))
            line = dict(kind=kind, seed=seed, numbers=nums,
                        correct=verdict(nums, limits)["correct"],
                        seconds=time.perf_counter() - h.t_start)
            lines.append(line)
            print(json.dumps(line), flush=True)
    for line in calibrate.summary(lines, limits):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
