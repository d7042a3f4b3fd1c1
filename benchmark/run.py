"""Run one cell of the benchmark of ``zebra_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the root of the
checkout; its configuration is the file the entry names, its traffic
``benchmark/traffic/<traffic>.json`` (whose ``loop`` names the loop in
``benchmark/loops/``), the limits of its check
``benchmark/limits/<cell>.json``, and each per-layer metric's reader
``benchmark/metrics/<metric>.py``. Without ``--trace`` the run reports the
cell's end-to-end metrics; with it, its per-layer metrics, read from a
traced stretch after the window. Either way it checks what the window's
path produced against the plain reference (``benchmark/reference/``) and
prints each compared number beside its limit, on standard error and as
the last key of the result, the last line of standard output.

Exits 2 without as many CUDA devices as the cell asks for, and 3 if JAX or
the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "zebra_tpu")


def _paths() -> None:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


class Harness:
    """What a loop is given: the cell's files, the run's arguments, the
    device, and the measurements every loop takes the same way."""

    def __init__(self, spec: dict, cell: dict, seed: int, seconds: float,
                 trace: bool, device, bench: Path = BENCH,
                 root: Path = ROOT, t_start: float = None):
        import torch

        self.spec, self.cell = spec, cell
        conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
        self.config = json.loads((root / conf["file"]).read_text())
        self.traffic = json.loads(
            (bench / "traffic" / f"{cell['traffic']}.json").read_text())
        limits = bench / "limits" / f"{cell['name']}.json"
        self.limits = (json.loads(limits.read_text()) if limits.exists()
                       else {})
        self.bench, self.seed, self.seconds = bench, int(seed), float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.ref_device = self.device
        self.t_start = T_START if t_start is None else t_start
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def reports(self, kind: str) -> list:
        """The names of the metrics of ``kind`` (end_to_end, per_layer)
        this cell reports."""
        return [m["name"] for m in reports(self.spec, kind, self.cell["name"])]

    def log(self, what: str) -> None:
        """A line on standard error: seconds since the process started."""
        print(f"[bench] {time.perf_counter() - self.t_start:9.3f} s {what}",
              file=sys.stderr, flush=True)

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reports(spec: dict, kind: str, cell: str) -> list:
    """The metrics of ``kind`` (end_to_end, per_layer) a cell reports."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def read_layer(bench: Path, name: str, ctx: dict):
    """Run the reader ``metrics/<name>.py`` on the traced context."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        bench / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _device(h, out: dict) -> dict:
    import torch

    dev = dict(platform="cpu", kind="cpu", count=1,
               memory_peak_bytes=out["memory_peak"])
    if h.device.type == "cuda":
        dev.update(platform="gpu",
                   kind=torch.cuda.get_device_name(h.device),
                   count=int(h.cell["chips"]), power_limit_w=_power_limit())
    if h.trace:
        tr = out["layer"]["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["span_s"])
    return dev


def _power_limit():
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(got.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(h: Harness) -> dict:
    """Run the cell's loop and build the result object."""
    from benchmark import checks

    loop = importlib.import_module(f"benchmark.loops.{h.traffic['loop']}")
    out = loop.run(h)
    name = h.cell["name"]
    metrics = {}
    if h.trace:
        for m in reports(h.spec, "per_layer", name):
            v = read_layer(h.bench, m["name"], out["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in reports(h.spec, "end_to_end", name):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    v = checks.verdict(out["numbers"], h.limits)
    result = dict(correct=v["correct"], attempted=int(out["attempted"]),
                  failed=int(out["failed"]), metrics=metrics,
                  device=_device(h, out))
    if h.trace:
        tr = out["layer"]["trace"]
        result["breakdown"] = dict(device_ops=tr["device_ops"],
                                   idle_gaps=tr["idle_gaps"])
    result["checks"] = v["checks"]
    return result


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _paths()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(
            cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    h = Harness(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    result = run_cell(h)
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
