"""Package rules of the port (zebra_tpu_torch): it never imports JAX, the
JAX package or pandas (the card's machine has none), nor loads the JAX
package's native library; entry points run on CUDA unless asked for the CPU
and raise without a card; ids that f32 cannot hold raise; configurations
outside the ported slice raise."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from zebra_tpu.config import Config as JaxConfig
from zebra_tpu_torch import bridge, cli, resolve_device
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data import split_data, synthetic_stream
from zebra_tpu_torch.index import merge as pm
from zebra_tpu_torch.index import streaming as pst
from zebra_tpu_torch.models.memory import MemoryState, init_memory
from zebra_tpu_torch.models.tgn import init_seed_params, init_tgn_params
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor
from zebra_tpu_torch.train.loop import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "zebra_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|zebra_tpu|pandas)(\.|\s|,|$)", re.M)


def test_import_leaves_jax_out():
    """Importing the package, every submodule and chip_smoke pulls in
    neither jax, zebra_tpu nor pandas (fresh interpreter)."""
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in PORT_FILES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zebra_tpu', 'pandas')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_parallel_package_imports_no_jax():
    """``zebra_tpu_torch.parallel`` alone, in a fresh interpreter, pulls in
    neither jax nor zebra_tpu (it keeps its own copy of the ZEBRA_*
    handling of zebra_tpu/parallel/distributed.py)."""
    code = (
        "import sys\n"
        "import zebra_tpu_torch.parallel as p\n"
        "from zebra_tpu_torch.parallel import launch, sharding\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zebra_tpu')]\n"
        "assert not bad, bad\n"
        "print(p.local_lanes(4, 2, 1))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["range(2,", "4)"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_has_no_jax_import(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def _small_cfg(**kw):
    base = dict(node_dim=8, time_dim=8, memory_dim=8, topk=3, n_nodes=10,
                n_edges=10, edge_dim=2)
    return Config(**{**base, **kw})


def _state(cfg):
    return (init_memory(cfg.n_nodes, cfg.memory_dim, cfg.msg_table_dim,
                        device="cpu"),
            pst.init_tppr_state(cfg.n_tppr, cfg.n_nodes, cfg.topk, "cpu"))


ENTRY_POINTS = {
    "resolve_device": lambda cfg: resolve_device(),
    "init_tppr_state": lambda cfg: pst.init_tppr_state(1, 4, 2),
    "init_memory": lambda cfg: init_memory(4, 8, 8),
    "init_tgn_params": lambda cfg: init_tgn_params(cfg, torch.Generator()),
    "bridge.to_tensor": lambda cfg: bridge.to_tensor(np.zeros(2)),
    "LinkPredictor": lambda cfg: LinkPredictor(
        cfg, init_tgn_params(cfg, torch.Generator(), "cpu"), *_state(cfg),
        np.zeros((10, 2), np.float32)),
    "Trainer": lambda cfg: Trainer(cfg, _splits(), None),
    "init_seed_params": lambda cfg: init_seed_params(
        cfg.replace(parallel_runs=2)),
    "EnsemblePredictor": lambda cfg: EnsemblePredictor(
        cfg, init_seed_params(cfg.replace(parallel_runs=2), "cpu"),
        *(MemoryState(*(torch.stack([x, x]) for x in _state(cfg)[0])),
          _state(cfg)[1]), np.zeros((10, 2), np.float32)),
    "LinkPredictor.from_checkpoint":
        lambda cfg: LinkPredictor.from_checkpoint("x.ckpt"),
    "cli.main": lambda cfg: cli.main(["-d", "x", "--data_dir", "none"]),
}


def _splits():
    data, _ = synthetic_stream(60, 5, 5, seed=0)
    return split_data(data.sources, data.destinations, data.timestamps,
                      data.edge_idxs, data.labels)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](_small_cfg())


def test_cpu_runs_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    assert pst.init_tppr_state(1, 4, 2, device="cpu").data.shape == (4, 9)


def test_merge_wrapper_refuses_other_devices():
    params = pst.TpprParams.create((0.1,), (0.9,), 2)
    rows = torch.empty((1, 2, 9), device="meta")
    one = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        pm.merge_both(rows, one, one, one, one.float(), params)


@pytest.mark.parametrize("call", [
    lambda: pst.init_tppr_state(1, 1 << 24, 2, device="cpu"),
    lambda: pst.check_id_width(n_edges=1 << 24),
    lambda: LinkPredictor(_small_cfg(n_edges=1 << 24),
                          init_tgn_params(_small_cfg(), torch.Generator(),
                                          "cpu"),
                          *_state(_small_cfg()), np.zeros((10, 2), np.float32),
                          device="cpu"),
    lambda: pst.streaming_scan(
        pst.init_tppr_state(1, 4, 2, device="cpu"),
        pst.TpprParams.create((0.1,), (0.9,), 2), [1], [2], [3], [1.0],
        [(1 << 24) - 1], [True]),
], ids=["nodes", "edges", "predictor", "scan_edge_id"])
def test_ids_past_f32_width_raise(call):
    with pytest.raises(ValueError, match="2\\^24"):
        call()


@pytest.mark.parametrize("field,value", [
    ("debug_nans", True),
    ("host_backup", True),
    ("aggregator", "mean"),
    ("message_function", "mlp"),
    ("use_source_embedding_in_message", True),
    ("use_destination_embedding_in_message", True),
    ("interleave_shards", 2),
    ("fused_dispatch", True),
    ("lazy_unique_cap", -1),
    ("n_devices", 2),
    ("owner_aligned_waves", True),
])
def test_config_refuses_values_outside_the_slice(field, value):
    """A JAX config outside the ported slice raises, naming the field. The
    single-device model options (aggregator, message function, message
    sources, lazy compaction, debug_nans), the host-backup protocol and
    the row-sharded layout (``n_devices=2`` for one seed, owner-aligned
    waves, the interleave's shard count) are ported: accepted, with JAX's
    message and cell widths."""
    jcfg = JaxConfig(**{field: value})
    if field in ("debug_nans", "aggregator", "message_function",
                 "use_source_embedding_in_message",
                 "use_destination_embedding_in_message", "lazy_unique_cap",
                 "host_backup", "interleave_shards", "n_devices",
                 "owner_aligned_waves"):
        cfg = Config.from_dict(dataclasses.asdict(jcfg))
        assert getattr(cfg, field) == value
        for width in ("message_dim", "msg_table_dim", "cell_input_dim"):
            assert getattr(cfg, width) == getattr(jcfg, width), width
        return
    with pytest.raises(ValueError, match=field):
        Config.from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("tower", ["graph_attention", "graph_sum",
                                   "identity", "time"])
def test_config_accepts_the_towers(tower):
    jcfg = JaxConfig(embedding_module=tower, alpha_list=(0.1, 0.1),
                     beta_list=(0.05, 0.95))
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    assert cfg.hidden_dim == jcfg.hidden_dim == cfg.node_dim
    assert cfg.needs_adjacency == jcfg.needs_adjacency
    assert not cfg.uses_tppr and not cfg.keeps_tppr_index


def test_config_from_jax_dict_keeps_fields_and_derived_widths():
    jcfg = JaxConfig(node_dim=100, time_dim=100, memory_dim=100, topk=20,
                     alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95),
                     n_nodes=40001, n_edges=120001, edge_dim=172)
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(cfg):
        want = getattr(jcfg, f.name)
        if f.name in ("alpha_list", "beta_list"):
            want = tuple(want)
        assert getattr(cfg, f.name) == want, f.name
    for prop in ("n_tppr", "hidden_dim", "message_dim", "compact_messages",
                 "msg_table_dim", "cell_input_dim"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.mxu_dtype is None
    assert Config(compute_dtype="bfloat16").mxu_dtype == torch.bfloat16
    # defaults agree with the JAX Config's
    base = Config()
    for f in dataclasses.fields(base):
        want = getattr(JaxConfig(), f.name)
        assert getattr(base, f.name) == (tuple(want) if isinstance(
            want, (list, tuple)) else want), f.name


def test_a_seed_parallel_trainer_serves_as_an_ensemble(tmp_path):
    """The JAX package's from_trainer guards: a seed-parallel Trainer serves
    through EnsemblePredictor, a single-seed one through LinkPredictor."""
    one, par = (Trainer(_small_cfg(parallel_runs=s,
                                   checkpoint_dir=str(tmp_path)),
                        _splits(), None, device="cpu") for s in (1, 2))
    with pytest.raises(ValueError, match="EnsemblePredictor.from_trainer"):
        LinkPredictor.from_trainer(par)
    with pytest.raises(ValueError, match="needs a seed-parallel Trainer"):
        EnsemblePredictor.from_trainer(one)
    ens = EnsemblePredictor.from_trainer(par)
    assert ens.n_models == 2 and ens.mem.memory.shape[0] == 2 * ens.cfg.n_nodes


def test_scheduler_is_the_port_own_library():
    """The wave scheduler loads the port's build of csrc/wave_schedule.cc,
    never the JAX package's libzt_ingest.so (fresh interpreter)."""
    code = (
        "from zebra_tpu_torch.index.waves import wave_schedule\n"
        "print(wave_schedule([1, 2], [3, 1], [2, 3], 4, 8)[2])\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libzt_ingest' not in maps\n"
        "assert 'libwave_schedule-' in maps\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2"]
