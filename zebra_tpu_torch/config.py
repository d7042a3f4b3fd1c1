"""Configuration of the port: the fields of ``zebra_tpu/config.py:Config``
with the same names and defaults, the derived widths, the run name, the
state-compatibility check of checkpoints and the command-line parser.

``Config.from_dict(dataclasses.asdict(jax_cfg))`` carries a JAX config over
(unknown fields are ignored), and ``Config.from_args`` takes a JAX command
line. A value outside the ported slice raises, so a configuration the port
cannot run is refused up front instead of running something else."""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the embedding modules of the JAX package, all ported
TOWERS = ("diffusion", "graph_attention", "graph_sum", "identity", "time")
RECURSIVE = ("graph_attention", "graph_sum")
AGGREGATORS = ("last", "mean")
MESSAGE_FUNCTIONS = ("identity", "mlp")


def _device_name(name: str) -> str:
    """``--device``'s value: ``cpu``, ``cuda`` or ``cuda:<index>``."""
    kind, _, index = name.partition(":")
    if kind == "cpu" and not index or kind == "cuda" and (
            not index or index.isdigit()):
        return name
    raise argparse.ArgumentTypeError(
        f"{name!r}: expected cpu, cuda or cuda:<index>")


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ('float32' | 'bfloat16') → torch dtype."""
    return _DTYPES[name]


@dataclass(frozen=True)
class Config:
    # ---- data ----
    data: str = "wikipedia"          # dataset name: {data_dir}/{data}/ml_{data}.csv
    data_dir: str = "data"
    bs: int = 200

    # ---- model dims ----
    node_dim: int = 100
    time_dim: int = 100
    memory_dim: int = 100

    # ---- T-PPR index ----
    tppr_strategy: str = "streaming"
    topk: int = 10
    alpha_list: Sequence[float] = (0.1,)
    beta_list: Sequence[float] = (0.9,)
    n_degree: int = 10               # the pruning BFS's width and depth,
    n_layer: int = 2                 # and the recursive towers' (neighbors
                                     # per hop, hops)

    # ---- towers ----
    embedding_module: str = "diffusion"
    use_source_embedding_in_message: bool = False
    use_destination_embedding_in_message: bool = False
    memory_updater: str = "gru"
    message_function: str = "identity"
    aggregator: str = "last"
    n_head: int = 2
    dropout: float = 0.1

    # ---- optimization ----
    n_epoch: int = 50
    lr: float = 1e-4
    patience: int = 5                # early-stop patience on val AP
    drop_out: float = 0.3            # the reference's vestigial --drop_out
    n_runs: int = 1
    task: str = "link"               # "link" | "node" (link training, then
                                     # the node-classification decoder)
    node_decoder_steps: int = 500
    node_decoder_lr: float = 1e-3
    parallel_runs: int = 1
    parallel_lr: Optional[Tuple[float, ...]] = None

    # ---- determinism ----
    enable_random: bool = False
    seed: int = 0

    # ---- feature handling ----
    ignore_edge_feats: bool = False
    ignore_node_feats: bool = False
    real_edge_feats: Optional[bool] = None  # set by the Trainer: whether a
                                     # genuine edge-feature matrix was
                                     # supplied (serving's guard reads it)

    # ---- observability ----
    debug_nans: bool = False
    trace_dir: Optional[str] = None  # torch.profiler trace of one epoch here
    trace_epoch: int = 1
    profile: bool = False            # synchronize after each wave scan so
                                     # index_seconds covers the device work

    # ---- checkpointing / logging ----
    save_best: bool = False
    checkpoint_dir: str = "saved_checkpoints"
    log_dir: str = "log"
    state_every: int = 0             # full-state checkpoint every N epochs
    resume_state: Optional[str] = None

    # ---- devices, superchunks, kernels ----
    n_devices: int = 1
    dist_coordinator: Optional[str] = None
    dist_num_processes: int = 1
    dist_process_id: int = 0
    index_chunk: int = 65536
    wave_cap: int = 64
    fused_dispatch: bool = False
    owner_aligned_waves: Optional[bool] = None
    interleave_node_ids: Optional[bool] = None
    interleave_shards: int = 0
    host_backup: Optional[bool] = None   # val/test table backups in host
                                     # memory (None: when only they fit)
    pallas_merge: bool = True        # the hand-written merge kernel (on the
                                     # card: csrc/santa_merge.cu)
    lazy_unique_cap: int = 0
    prng_impl: str = "rbg"           # JAX's PRNG name, kept for the state
                                     # check; the port draws from
                                     # torch.Generators

    # ---- storage / matmul dtypes ----
    message_dtype: str = "bfloat16"
    compute_dtype: str = "float32"
    memory_dtype: str = "bfloat16"

    # ---- filled from data ----
    n_nodes: int = 0
    n_edges: int = 0
    edge_dim: int = 1
    node_feat_dim: int = 0

    def __post_init__(self):
        object.__setattr__(self, "alpha_list",
                           tuple(float(a) for a in self.alpha_list))
        object.__setattr__(self, "beta_list",
                           tuple(float(b) for b in self.beta_list))
        if self.parallel_lr is not None:
            object.__setattr__(self, "parallel_lr",
                               tuple(float(x) for x in self.parallel_lr))
        if len(self.alpha_list) != len(self.beta_list):
            raise ValueError("alpha_list and beta_list must have equal length")
        # the JAX Trainer's checks of the seed axis (zebra_tpu/train/
        # loop.py:219-250), made here so a command line fails up front
        n_seeds = self.n_seeds
        if n_seeds > 1 and self.fused_dispatch:
            raise ValueError(
                "parallel_runs > 1 does not support --fused_dispatch (the "
                "split two-dispatch pipeline is the production path; the "
                "fused program has no seed-parallel variant)")
        if self.parallel_lr is not None:
            if n_seeds == 1:
                raise ValueError(
                    "--parallel_lr requires --parallel_runs > 1 (use --lr "
                    "for a single run)")
            if len(self.parallel_lr) != n_seeds:
                raise ValueError(
                    f"--parallel_lr needs one value per parallel run: got "
                    f"{len(self.parallel_lr)} for {n_seeds} runs")
        outside = {
            "tppr_strategy": self.tppr_strategy not in ("streaming",
                                                        "pruning"),
            "embedding_module": self.embedding_module not in TOWERS,
            "aggregator": self.aggregator not in AGGREGATORS,
            "message_function":
                self.message_function not in MESSAGE_FUNCTIONS,
            "fused_dispatch": bool(self.fused_dispatch),
            "pallas_merge": not self.pallas_merge,
            "prng_impl": self.prng_impl != "rbg",
            "memory_updater": self.memory_updater not in ("gru", "rnn"),
            "task": self.task not in ("link", "node"),
            "message_dtype": self.message_dtype not in _DTYPES,
            "memory_dtype": self.memory_dtype not in _DTYPES,
            "compute_dtype": self.compute_dtype not in _DTYPES,
        }
        bad = [f"{k}={getattr(self, k)!r}" for k, v in outside.items() if v]
        if bad:
            raise ValueError(
                "outside the ported slice (streaming and pruning "
                "strategies, the diffusion, graph_attention, graph_sum, "
                "identity and time towers, last and mean aggregators, "
                "identity and mlp message functions, memory- or "
                "embedding-sourced messages, per-position or compacted lazy "
                "updates, debug_nans, the hand-written merge kernel, one "
                "device per process, whole seeds per device or one seed's "
                "node rows over the devices): " + ", ".join(bad)
            )
        n_dev = int(self.n_devices)
        if n_seeds == 1 and n_dev > 1 and self.bs % n_dev:
            raise ValueError(
                f"bs ({self.bs}) must be a multiple of the mesh size "
                f"({n_dev}): each rank takes an equal block of every "
                "batch's events")
        if n_dev > 1 and n_seeds > 1 and n_seeds % n_dev:
            raise ValueError(
                f"parallel_runs ({n_seeds}) must be a multiple of the mesh "
                f"size ({n_dev}): the seed axis shards whole seeds per "
                "device")
        n_proc = int(self.dist_num_processes)
        if n_proc > 1 and n_dev not in (0, n_proc):
            raise ValueError(
                f"--n_devices {n_dev} with --dist_num_processes {n_proc}: "
                "one process per device, so the mesh has as many devices as "
                "processes (--n_devices 0 takes them all)")
        if self.node_dim != self.memory_dim:
            raise ValueError(
                f"node_dim={self.node_dim} must equal memory_dim="
                f"{self.memory_dim}: every tower feeds memory rows as node "
                "representations")
        q_dim = self.node_dim + self.time_dim
        if self.embedding_module == "graph_attention" and q_dim % self.n_head:
            raise ValueError(
                f"n_head={self.n_head} must divide the attention query width "
                f"node_dim + time_dim = {q_dim}")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        """Build from a mapping such as ``dataclasses.asdict(jax_cfg)`` or
        the dict a checkpoint stores; keys that are not fields here are
        ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def single_seed(self) -> "Config":
        """This config for one seed on one device: what serves one seed of
        a seed-parallel (or seed-sharded) run."""
        return self.replace(parallel_runs=1, parallel_lr=None, n_devices=1,
                            dist_coordinator=None, dist_num_processes=1,
                            dist_process_id=0)

    @property
    def n_tppr(self) -> int:
        return len(self.alpha_list)

    @property
    def hidden_dim(self) -> int:
        """Link-head input width: for the diffusion tower node_dim per
        member plus the source tower, for every other tower node_dim."""
        if self.embedding_module == "diffusion":
            return self.node_dim * (self.n_tppr + 1)
        return self.node_dim

    @property
    def message_dim(self) -> int:
        """Raw-message width [src_part; dst_part; edge_feat; time_enc]. Under
        a use_*_embedding_in_message flag that part is the batch's
        embedding, ``hidden_dim`` wide, instead of the memory row."""
        src_part = (self.hidden_dim if self.use_source_embedding_in_message
                    else self.memory_dim)
        dst_part = (self.hidden_dim
                    if self.use_destination_embedding_in_message
                    else self.memory_dim)
        return src_part + dst_part + self.edge_dim + self.time_dim

    @property
    def compact_messages(self) -> bool:
        """Whether stored message rows omit the sender-memory part: a node's
        memory cannot change between a store and its commit, so every
        consumer already holds that part (the updater cell's own gather of
        the hidden state) and ``message_input`` re-attaches it. Off only
        under use_source_embedding_in_message, whose sender part is the
        batch's embedding, not the memory row."""
        return not self.use_source_embedding_in_message

    @property
    def need_emb(self) -> bool:
        """Whether messages take the batch's embeddings (a message-source
        flag): the eval and train protocols then read the forward's src
        and dst rows, and serving's observe runs a forward first."""
        return (self.use_source_embedding_in_message
                or self.use_destination_embedding_in_message)

    @property
    def msg_table_dim(self) -> int:
        """Stored width of a pending-message row, excluding the flag column."""
        if self.compact_messages:
            return self.message_dim - self.memory_dim
        return self.message_dim

    @property
    def cell_input_dim(self) -> int:
        """Updater-cell input width: the raw message, or the mlp message
        function's output (memory_dim wide)."""
        return (self.memory_dim if self.message_function == "mlp"
                else self.message_dim)

    @property
    def mxu_dtype(self):
        """Matmul input dtype (models/cells.py:matmul), or None for f32."""
        if self.compute_dtype == "bfloat16":
            return torch.bfloat16
        return None

    @property
    def needs_adjacency(self) -> bool:
        """Whether this config queries a padded-CSR adjacency index: the
        pruning strategy's bounded BFS and the recursive towers both do
        (``zebra_tpu/config.py:needs_adjacency``). Shared by the Trainer and
        ``LinkPredictor.from_checkpoint`` so the two cannot disagree."""
        return (self.tppr_strategy == "pruning"
                or self.embedding_module in RECURSIVE)

    @property
    def uses_tppr(self) -> bool:
        """Whether the tower reads T-PPR queries: only diffusion does. The
        other towers read memory rows, and the recursive ones the adjacency
        index, under either strategy."""
        return self.embedding_module == "diffusion"

    @property
    def keeps_tppr_index(self) -> bool:
        """Whether a T-PPR index state and its wave scans exist: the
        diffusion tower under the streaming strategy."""
        return self.uses_tppr and self.tppr_strategy == "streaming"

    # Fields that shape or give meaning to a ``save_state`` checkpoint: a
    # restore across a change of any of them would mis-shape the state or
    # read it at the wrong packed layout (the JAX package's list).
    STATE_FIELDS = (
        "n_nodes", "n_edges", "edge_dim",
        "node_dim", "time_dim", "memory_dim", "n_head",
        "embedding_module", "memory_updater", "message_function",
        "aggregator",
        "topk", "alpha_list", "beta_list", "tppr_strategy",
        "use_source_embedding_in_message",
        "use_destination_embedding_in_message",
        "message_dtype", "memory_dtype", "prng_impl",
        "parallel_runs",
        "interleave_shards",
    )

    @classmethod
    def state_compat_diff(cls, saved: "Config", live: "Config") -> List[str]:
        """Field-level diff of the state-shaping fields between a
        checkpoint's config and the live one, in the JAX package's wording;
        empty = compatible. ``n_layer`` counts where a recursive tower is
        involved, whose parameters hold one layer per hop."""
        diffs = []
        for name in cls.STATE_FIELDS:
            sv, lv = getattr(saved, name), getattr(live, name)
            if name == "parallel_runs":
                sv, lv = max(1, int(sv)), max(1, int(lv))
            if sv != lv:
                diffs.append(f"{name}: checkpoint={sv!r} vs live={lv!r}")
        if (saved.embedding_module in RECURSIVE
                or live.embedding_module in RECURSIVE):
            if saved.n_layer != live.n_layer:
                diffs.append(f"n_layer: checkpoint={saved.n_layer!r} vs "
                             f"live={live.n_layer!r}")
        if (saved.parallel_lr is None) != (live.parallel_lr is None):
            diffs.append(
                f"parallel_lr: checkpoint "
                f"{'set' if saved.parallel_lr is not None else 'unset'} vs "
                f"live {'set' if live.parallel_lr is not None else 'unset'} "
                f"(per-seed lr rides the optimizer state pytree)")
        return diffs

    @property
    def n_seeds(self) -> int:
        """Seeds trained together (``parallel_runs``, at least 1)."""
        return max(1, int(self.parallel_runs))

    def run_name(self) -> str:
        """The derived config string that names the log file and the
        checkpoints (the JAX package's string for the same fields)."""
        name = self.data
        if self.embedding_module == "diffusion":
            name += f"_{self.tppr_strategy}_topk_{self.topk}"
            name += f"_alpha_{list(self.alpha_list)}_beta_{list(self.beta_list)}"
            if self.tppr_strategy == "pruning":
                name += f"_width_{self.n_degree}_depth_{self.n_layer}"
        name += f"_bs_{self.bs}_layer_{self.n_layer}_epoch_{self.n_epoch}_lr_{self.lr}"
        if self.enable_random:
            name += "_random_seed"
        if self.parallel_runs > 1:
            name += f"_par_{self.parallel_runs}"
        return name

    # ------------------------------------------------------------------ CLI
    @staticmethod
    def arg_parser() -> argparse.ArgumentParser:
        """The JAX package's parser (every flag under its name and default),
        plus ``--device``: ``cuda`` (rank r of a seed-sharded run on
        ``cuda:r``), a named card such as ``cuda:0`` (every rank on it), or
        ``cpu``."""
        p = argparse.ArgumentParser("zebra_tpu_torch training")
        p.add_argument("-d", "--data", type=str, default="wikipedia")
        p.add_argument("--data_dir", type=str, default="data")
        p.add_argument("--bs", type=int, default=200)
        p.add_argument("--n_degree", type=int, default=10)
        p.add_argument("--n_head", type=int, default=2)
        p.add_argument("--n_epoch", type=int, default=50)
        p.add_argument("--n_layer", type=int, default=2)
        p.add_argument("--lr", type=float, default=1e-4)
        p.add_argument("--patience", type=int, default=5)
        p.add_argument("--n_runs", type=int, default=1)
        p.add_argument("--task", type=str, default="link",
                       choices=["link", "node"])
        p.add_argument("--node_decoder_steps", type=int, default=500)
        p.add_argument("--node_decoder_lr", type=float, default=1e-3)
        p.add_argument("--parallel_runs", type=int, default=1)
        p.add_argument("--parallel_lr", type=float, nargs="+", default=None)
        p.add_argument("--drop_out", type=float, default=0.3)
        p.add_argument("--memory_updater", type=str, default="gru",
                       choices=["gru", "rnn"])
        p.add_argument("--embedding_module", type=str, default="diffusion")
        p.add_argument("--message_function", type=str, default="identity",
                       choices=["mlp", "identity"])
        p.add_argument("--use_source_embedding_in_message", action="store_true")
        p.add_argument("--use_destination_embedding_in_message",
                       action="store_true")
        p.add_argument("--aggregator", type=str, default="last")
        p.add_argument("--enable_random", action="store_true")
        p.add_argument("--save_best", action="store_true")
        p.add_argument("--tppr_strategy", type=str, default="streaming",
                       choices=["streaming", "pruning"])
        p.add_argument("--topk", type=int, default=10)
        p.add_argument("--alpha_list", type=float, nargs="+", default=[0.1])
        p.add_argument("--beta_list", type=float, nargs="+", default=[0.9])
        p.add_argument("--ignore_edge_feats", action="store_true")
        p.add_argument("--ignore_node_feats", action="store_true")
        p.add_argument("--node_dim", type=int, default=100)
        p.add_argument("--time_dim", type=int, default=100)
        p.add_argument("--memory_dim", type=int, default=100)
        p.add_argument("--n_devices", type=int, default=1)
        p.add_argument("--dist_coordinator", type=str, default=None)
        p.add_argument("--dist_num_processes", type=int, default=1)
        p.add_argument("--dist_process_id", type=int, default=0)
        p.add_argument("--index_chunk", type=int, default=65536)
        p.add_argument("--wave_cap", type=int, default=64)
        p.add_argument("--fused_dispatch", action="store_true")
        p.add_argument("--owner_aligned_waves", dest="owner_aligned_waves",
                       action="store_true", default=None)
        p.add_argument("--no_owner_aligned_waves",
                       dest="owner_aligned_waves", action="store_false")
        p.add_argument("--interleave_node_ids", dest="interleave_node_ids",
                       action="store_true", default=None)
        p.add_argument("--no_interleave_node_ids",
                       dest="interleave_node_ids", action="store_false")
        p.add_argument("--host_backup", dest="host_backup",
                       action="store_true", default=None)
        p.add_argument("--no_host_backup", dest="host_backup",
                       action="store_false")
        p.add_argument("--debug_nans", action="store_true")
        p.add_argument("--trace_dir", type=str, default=None)
        p.add_argument("--trace_epoch", type=int, default=1)
        p.add_argument("--profile", action="store_true")
        p.add_argument("--no_pallas_merge", dest="pallas_merge",
                       action="store_false")
        p.add_argument("--lazy_unique_cap", type=int, default=0)
        p.add_argument("--prng_impl", type=str, default="rbg",
                       choices=["rbg", "threefry2x32"])
        p.add_argument("--message_dtype", type=str, default="bfloat16",
                       choices=["bfloat16", "float32"])
        p.add_argument("--memory_dtype", type=str, default="bfloat16",
                       choices=["bfloat16", "float32"])
        p.add_argument("--compute_dtype", type=str, default="float32",
                       choices=["bfloat16", "float32"])
        p.add_argument("--checkpoint_dir", type=str,
                       default="saved_checkpoints")
        p.add_argument("--log_dir", type=str, default="log")
        p.add_argument("--state_every", type=int, default=0)
        p.add_argument("--resume_state", type=str, default=None)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", type=_device_name, default="cuda")
        return p

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "Config":
        """Parse a command line (``--device`` is not a field: see
        :func:`zebra_tpu_torch.cli.main`)."""
        return cls.from_dict(vars(cls.arg_parser().parse_args(argv)))
