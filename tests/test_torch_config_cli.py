"""The port's Config against the JAX package's (zebra_tpu_torch/config.py):
the command-line parser takes every JAX flag under the same name and
default, a JAX command line gives the same fields, run names and
state-compatibility diffs are the JAX strings, and each flag outside the
ported slice raises."""

import dataclasses

import pytest

from zebra_tpu.config import Config as JaxConfig
from zebra_tpu_torch.config import Config


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


JAX_DEFAULTS = _defaults(JaxConfig.arg_parser())


@pytest.mark.parametrize("dest", sorted(JAX_DEFAULTS))
def test_parser_takes_every_jax_dest_with_its_default(dest):
    port = _defaults(Config.arg_parser())
    assert dest in port
    assert port[dest] == JAX_DEFAULTS[dest]


def test_parser_takes_every_jax_flag_and_adds_only_device():
    jax_flags, port_flags = _flags(JaxConfig.arg_parser()), _flags(
        Config.arg_parser())
    assert jax_flags <= port_flags
    assert port_flags - jax_flags == {"--device"}
    assert set(_defaults(Config.arg_parser())) - set(JAX_DEFAULTS) == {
        "device"}


def test_device_flag():
    parse = Config.arg_parser().parse_args
    assert parse([]).device == "cuda"
    assert parse(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        parse(["--device", "tpu"])


def test_jax_command_line_carries_over():
    argv = ["-d", "wiki", "--data_dir", "/d", "--bs", "100", "--topk", "20",
            "--alpha_list", "0.1", "0.2", "--beta_list", "0.5", "0.9",
            "--n_epoch", "7", "--patience", "2", "--task", "node",
            "--node_decoder_steps", "30", "--save_best", "--state_every", "2",
            "--memory_dtype", "float32", "--seed", "4", "--no_host_backup",
            "--no_interleave_node_ids", "--no_owner_aligned_waves",
            "--trace_dir", "/t", "--trace_epoch", "0", "--profile",
            "--ignore_edge_feats", "--resume_state", "/s.ckpt",
            "--index_chunk", "1024", "--memory_updater", "rnn"]
    jcfg, cfg = JaxConfig.from_args(argv), Config.from_args(argv)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


RUN_NAMES = [
    {},
    dict(data="wiki", topk=20, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95),
         bs=200, n_epoch=3, lr=1e-3),
    dict(data="toy", enable_random=True, n_layer=1, lr=3e-3),
    dict(data="mooc", tppr_strategy="pruning", n_degree=10, n_layer=2,
         topk=20, alpha_list=(0.1, 0.1), beta_list=(0.5, 0.95)),
] + [dict(data="wikipedia", embedding_module=tower, n_degree=10, n_layer=2,
          tppr_strategy=strategy)
     for tower, strategy in (("graph_attention", "streaming"),
                             ("graph_sum", "pruning"),
                             ("identity", "streaming"), ("time", "pruning"))]


@pytest.mark.parametrize("kw", RUN_NAMES, ids=[
    "default", "flagship", "random", "pruning", "graph_attention",
    "graph_sum", "identity", "time"])
def test_run_name_matches_jax(kw):
    assert Config(**kw).run_name() == JaxConfig(**kw).run_name()


BASE = dict(topk=5, alpha_list=(0.1,), beta_list=(0.9,), n_nodes=256,
            n_edges=1201, edge_dim=4)
DIFFS = {
    "same": {},
    "run_fields_only": dict(lr=1e-2, bs=17, n_epoch=3, patience=1,
                            index_chunk=1024, seed=5),
    "topk": dict(topk=4),
    "dims": dict(node_dim=32, memory_dim=32, time_dim=8),
    "alpha_beta": dict(alpha_list=(0.2,), beta_list=(0.8,)),
    "dtypes": dict(memory_dtype="float32", message_dtype="float32"),
    "extents": dict(n_nodes=384, n_edges=99, edge_dim=1),
    "updater": dict(memory_updater="rnn", n_head=4),
    "parallel_lr": dict(parallel_runs=2, parallel_lr=(1e-3, 3e-4)),
    # the BFS's width and depth shape no state: only the strategy differs
    "strategy": dict(tppr_strategy="pruning", n_degree=5, n_layer=3),
    # a recursive tower holds a layer per hop: n_layer counts there
    "recursive_tower": dict(embedding_module="graph_sum", n_layer=3),
    "memory_only_tower": dict(embedding_module="identity", n_layer=3),
}


@pytest.mark.parametrize("change", sorted(DIFFS))
def test_state_compat_diff_matches_jax(change):
    live = {**BASE, **DIFFS[change]}
    got = Config.state_compat_diff(Config(**BASE), Config(**live))
    want = JaxConfig.state_compat_diff(JaxConfig(**BASE), JaxConfig(**live))
    assert got == want
    assert bool(got) == (change not in ("same", "run_fields_only"))


OUTSIDE = [
    (["--parallel_runs", "2", "--fused_dispatch"], "parallel_runs"),
    (["--parallel_lr", "1e-3", "1e-4"], "parallel_lr"),
    (["--embedding_module", "graph_attention", "--n_head", "3"], "n_head"),
    (["--memory_dim", "64"], "memory_dim"),
    (["--aggregator", "max"], "aggregator"),
    (["--message_function", "mlp"], "message_function"),
    (["--use_source_embedding_in_message"], "use_source_embedding_in_message"),
    (["--use_destination_embedding_in_message"],
     "use_destination_embedding_in_message"),
    (["--no_pallas_merge"], "pallas_merge"),
    (["--fused_dispatch"], "fused_dispatch"),
    (["--prng_impl", "threefry2x32"], "prng_impl"),
    (["--n_devices", "0"], "n_devices"),
    (["--dist_coordinator", "host0:8476"], "dist_coordinator"),
    (["--dist_num_processes", "2"], "dist_num_processes"),
    (["--dist_process_id", "1"], "dist_process_id"),
    (["--host_backup"], "host_backup"),
    (["--interleave_node_ids"], "interleave_node_ids"),
    (["--owner_aligned_waves"], "owner_aligned_waves"),
    (["--debug_nans"], "debug_nans"),
    (["--lazy_unique_cap", "-1"], "lazy_unique_cap"),
]


# options the port once refused and now runs: their cases check that the
# flag is accepted and carries over with JAX's derived widths
OPENED = ("message_function", "use_source_embedding_in_message",
          "use_destination_embedding_in_message", "debug_nans",
          "lazy_unique_cap", "host_backup", "n_devices", "dist_coordinator",
          "dist_process_id", "interleave_node_ids", "owner_aligned_waves")


@pytest.mark.parametrize("argv,field", OUTSIDE,
                         ids=[f for _, f in OUTSIDE])
def test_flags_outside_the_slice_raise(argv, field):
    """A valid JAX command line outside the ported slice raises, naming the
    field (``--aggregator max``: JAX takes any aggregator string, the port
    only last and mean). The cases of OPENED are ported options: accepted,
    with JAX's value and message and cell widths."""
    jcfg = JaxConfig.from_args(argv)            # a valid JAX command line
    if field in OPENED:
        cfg = Config.from_args(argv)
        assert getattr(cfg, field) == getattr(jcfg, field)
        for width in ("message_dim", "msg_table_dim", "cell_input_dim"):
            assert getattr(cfg, width) == getattr(jcfg, width), width
        return
    with pytest.raises(ValueError, match=field):
        Config.from_args(argv)


def test_seed_axis_command_line_carries_over():
    argv = ["--parallel_runs", "3", "--parallel_lr", "1e-3", "3e-4", "1e-4",
            "--n_runs", "2"]
    jcfg, cfg = JaxConfig.from_args(argv), Config.from_args(argv)
    assert cfg.n_seeds == 3 and cfg.parallel_lr == (1e-3, 3e-4, 1e-4)
    for f in dataclasses.fields(cfg):
        want = getattr(jcfg, f.name)
        if f.name == "parallel_lr":
            want = tuple(want)
        assert getattr(cfg, f.name) == want, f.name


SEED_AXIS_REFUSALS = {
    "parallel_lr_length": (["--parallel_runs", "3", "--parallel_lr", "1e-3",
                            "1e-4"], "one value per parallel run: got 2 for 3"),
    "n_devices": (["--parallel_runs", "3", "--n_devices", "2"],
                  "parallel_runs \\(3\\) must be a multiple of the mesh "
                  "size \\(2\\)"),
}


@pytest.mark.parametrize("name", sorted(SEED_AXIS_REFUSALS))
def test_seed_axis_refusals_that_stand(name):
    """A JAX command line of the seed axis the port still refuses: a
    parallel_lr of the wrong length and seeds that do not divide over the
    devices (the JAX Trainer's checks and wording)."""
    argv, match = SEED_AXIS_REFUSALS[name]
    JaxConfig.from_args(argv)
    with pytest.raises(ValueError, match=match):
        Config.from_args(argv)


def test_seed_sharding_command_line_carries_over():
    """The flags of the seed axis over devices, now accepted with S a
    multiple of the device count: every field as JAX parses it; the port's
    ``--device`` takes a named card."""
    argv = ["--parallel_runs", "4", "--n_devices", "2", "--dist_coordinator",
            "host0:8476", "--dist_num_processes", "2", "--dist_process_id",
            "1", "--host_backup"]
    jcfg, cfg = JaxConfig.from_args(argv), Config.from_args(argv)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert Config.from_args(["--no_host_backup"]).host_backup is False
    assert Config.arg_parser().parse_args(
        ["--device", "cuda:0"]).device == "cuda:0"
    one = cfg.single_seed()
    assert (one.n_seeds, one.n_devices, one.dist_coordinator,
            one.dist_num_processes, one.dist_process_id) == (1, 1, None, 1, 0)
