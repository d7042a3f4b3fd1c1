"""Shared fixtures of the benchmark's own tests (CPU unless marked
``card``): a temporary copy of the benchmark cut to a tiny size, and the
card check, made inside a fixture."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_STREAM = dict(n_users=150, n_items=40, n_events=4000, edge_dim=8)
TINY_MODEL = dict(node_dim=16, memory_dim=16, time_dim=16, topk=5,
                  index_chunk=1000, n_degree=4)
TINY_SERVE = dict(round_events=2000, sample_from=3, sampled_steps=3,
                  profiled_steps=5)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and benchmark/ under ``dest``, every configuration
    and the serving traffic cut to a tiny size."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["stream"].update(TINY_STREAM)
        c["model"].update(TINY_MODEL)
        f.write_text(json.dumps(c))
    f = dest / "benchmark" / "traffic" / "serve.json"
    f.write_text(json.dumps(dict(json.loads(f.read_text()), **TINY_SERVE)))
    return dest


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_copy(tmp_path)


def harness(root: Path, workload: str, seed: int = 2 ** 31 + 5,
            trace: bool = False, seconds: float = 1.0, device="cpu"):
    from benchmark import run

    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(c for c in spec["workloads"] if c["name"] == workload)
    return run.Harness(spec, cell, seed, seconds, trace, device,
                       bench=root / "benchmark", root=root)
