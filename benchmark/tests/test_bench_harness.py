"""The harness itself: cells, traffic, limits and metric readers found by
name; the streams made from the seed; the result line; the imports; and a
run without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import ROOT, harness

from benchmark import run, streams

FORBIDDEN = {"jax", "jaxlib", "flax", "zebra_tpu"}


def test_new_cell_found_by_name(tiny):
    """A configuration, traffic mix, limits and metric reader dropped into
    the benchmark's folders run as a new cell with no edit of code."""
    bench = tiny / "benchmark"
    conf = json.loads((bench / "configs" / "zebra-wikipedia.json").read_text())
    conf["model"]["topk"] = 4
    (bench / "configs" / "zebra-small.json").write_text(json.dumps(conf))
    (bench / "traffic" / "train-s2.json").write_text(json.dumps(
        {"loop": "train", "parallel_runs": 2, "steps_checked": 3}))
    (bench / "limits" / "small.train-s2.json").write_text(json.dumps(
        {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
         "memory_gap": 1e-3, "index_gap": 1e-5}))
    (bench / "metrics" / "window_seconds.train.py").write_text(
        "def read(ctx):\n    return ctx['window_s']\n")
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="zebra-small",
                                file="benchmark/configs/zebra-small.json"))
    spec["workloads"].append(dict(name="small.train-s2", config="zebra-small",
                                  traffic="train-s2", chips=1, why="test"))
    spec["per_layer"].append(dict(
        name="window_seconds.train", unit="s", better="lower",
        source="host_clock", layer="train step", moves="train_events_per_s",
        workloads=["small.train-s2"]))
    spec["end_to_end"][1]["workloads"].append("small.train-s2")
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run.run_cell(harness(tiny, "small.train-s2", trace=True))
    assert res["correct"], res["checks"]
    # the new reader, and no metric that does not list the cell
    assert set(res["metrics"]) == {"window_seconds.train"}
    assert res["attempted"] > 0


@pytest.mark.parametrize("n", [500, 3000])
def test_streams_follow_the_seed(n):
    one = streams.synthetic_events(n, 50, 20, 7)
    again = streams.synthetic_events(n, 50, 20, 7)
    other = streams.synthetic_events(n, 50, 20, 8)
    for a, b in zip(one, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(one.src, other.src)
    big = streams.sub_seeds(2 ** 33 + 1)
    assert (big >= 0).all() and (big < 2 ** 31).all()
    assert not np.array_equal(big, streams.sub_seeds(2 ** 33 + 2))


def test_train_negatives_follow_the_seed():
    sp = streams.split(streams.synthetic_events(2000, 60, 20, 3))
    a = streams.train_negatives(sp.train, streams.neg_base(5), 0)
    b = streams.train_negatives(sp.train, streams.neg_base(5), 0)
    c = streams.train_negatives(sp.train, streams.neg_base(5), 1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert set(np.unique(a)) <= set(np.unique(sp.train.dst))


@pytest.mark.parametrize("workload,trace", [
    ("wikipedia.train", False), ("wikipedia.serve", True),
    ("mooc-pruning.train", False), ("mooc-pruning.train", True)])
def test_result_line(tiny, workload, trace):
    res = run.run_cell(harness(tiny, workload, trace=trace))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["checks"]
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in run.reports(spec, kind, workload)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_and_a_plain_reference():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path
        if "reference" in path.parts:
            assert "zebra_tpu_torch" not in tops, path


def test_loaded_modules_after_a_run(tiny):
    """What a run loads, in its own process: no JAX, no JAX package."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r];"
        "from conftest import harness; from benchmark import run;"
        "run.run_cell(harness(__import__('pathlib').Path(%r), "
        "'wikipedia.train'));"
        "print(json.dumps(run.loaded_forbidden()))"
        % (str(ROOT), str(Path(__file__).parent), str(tiny)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _cli(cwd: Path, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wikipedia.train",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_cannot_run(tmp_path):
    """With only BENCHMARK.json and benchmark/, the program is missing."""
    root = tmp_path
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run;"
            "import json; spec = json.load(open('BENCHMARK.json'));"
            "h = run.Harness(spec, spec['workloads'][0], 1, 1, False, 'cpu');"
            "print(json.dumps(run.run_cell(h)))" % str(root))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "zebra_tpu_torch" in out.stderr


@pytest.mark.card
def test_cell_on_card(card, tiny):
    res = run.run_cell(harness(tiny, "wikipedia.train", trace=True,
                               device=card))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert "santa_waves_roofline" in res["metrics"]
