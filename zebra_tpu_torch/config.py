"""Configuration of the port: the fields of ``zebra_tpu/config.py:Config``
that the ported slice reads, with the same names and defaults.

``Config.from_dict(dataclasses.asdict(jax_cfg))`` carries a JAX config over
(unknown fields are ignored). A value outside the ported slice raises, so a
configuration the port cannot run is refused up front instead of running
something else."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ('float32' | 'bfloat16') → torch dtype."""
    return _DTYPES[name]


@dataclass(frozen=True)
class Config:
    # ---- model dims ----
    node_dim: int = 100
    time_dim: int = 100
    memory_dim: int = 100

    # ---- T-PPR index ----
    tppr_strategy: str = "streaming"
    topk: int = 10
    alpha_list: Sequence[float] = (0.1,)
    beta_list: Sequence[float] = (0.9,)

    # ---- towers ----
    embedding_module: str = "diffusion"
    use_source_embedding_in_message: bool = False
    use_destination_embedding_in_message: bool = False
    memory_updater: str = "gru"
    message_function: str = "identity"
    aggregator: str = "last"

    # ---- training ----
    bs: int = 200
    lr: float = 1e-4
    dropout: float = 0.1
    n_epoch: int = 50
    enable_random: bool = False
    seed: int = 0
    index_chunk: int = 65536
    wave_cap: int = 64
    lazy_unique_cap: int = 0

    # ---- seeds, devices, id layout ----
    parallel_runs: int = 1
    n_devices: int = 1
    owner_aligned_waves: Optional[bool] = None
    interleave_shards: int = 0

    # ---- storage / matmul dtypes ----
    message_dtype: str = "bfloat16"
    compute_dtype: str = "float32"
    memory_dtype: str = "bfloat16"

    # ---- filled from data ----
    n_nodes: int = 0
    n_edges: int = 0
    edge_dim: int = 1

    def __post_init__(self):
        object.__setattr__(self, "alpha_list",
                           tuple(float(a) for a in self.alpha_list))
        object.__setattr__(self, "beta_list",
                           tuple(float(b) for b in self.beta_list))
        if len(self.alpha_list) != len(self.beta_list):
            raise ValueError("alpha_list and beta_list must have equal length")
        outside = {
            "tppr_strategy": self.tppr_strategy != "streaming",
            "embedding_module": self.embedding_module != "diffusion",
            "aggregator": self.aggregator != "last",
            "message_function": self.message_function != "identity",
            "use_source_embedding_in_message":
                bool(self.use_source_embedding_in_message),
            "use_destination_embedding_in_message":
                bool(self.use_destination_embedding_in_message),
            "interleave_shards": int(self.interleave_shards or 0) > 1,
            "parallel_runs": int(self.parallel_runs) > 1,
            "n_devices": int(self.n_devices) != 1,
            "owner_aligned_waves": bool(self.owner_aligned_waves),
            "lazy_unique_cap": int(self.lazy_unique_cap) != 0,
            "memory_updater": self.memory_updater not in ("gru", "rnn"),
            "message_dtype": self.message_dtype not in _DTYPES,
            "memory_dtype": self.memory_dtype not in _DTYPES,
            "compute_dtype": self.compute_dtype not in _DTYPES,
        }
        bad = [f"{k}={getattr(self, k)!r}" for k, v in outside.items() if v]
        if bad:
            raise ValueError(
                "outside the ported slice (streaming strategy, diffusion "
                "tower, last aggregator, identity messages, per-position lazy "
                "updates, one model on one device): "
                + ", ".join(bad)
            )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        """Build from a mapping such as ``dataclasses.asdict(jax_cfg)``;
        keys that are not fields here are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def n_tppr(self) -> int:
        return len(self.alpha_list)

    @property
    def hidden_dim(self) -> int:
        """Link-head input width: node_dim per member plus the source tower."""
        return self.node_dim * (self.n_tppr + 1)

    @property
    def message_dim(self) -> int:
        """Raw-message width [src_part; dst_part; edge_feat; time_enc]."""
        return 2 * self.memory_dim + self.edge_dim + self.time_dim

    @property
    def compact_messages(self) -> bool:
        """Stored message rows omit the sender-memory part (always so in this
        slice: only use_source_embedding_in_message turns it off)."""
        return not self.use_source_embedding_in_message

    @property
    def msg_table_dim(self) -> int:
        """Stored width of a pending-message row, excluding the flag column."""
        if self.compact_messages:
            return self.message_dim - self.memory_dim
        return self.message_dim

    @property
    def cell_input_dim(self) -> int:
        """Updater-cell input width (identity message function)."""
        return self.message_dim

    @property
    def mxu_dtype(self):
        """Matmul input dtype (models/cells.py:matmul), or None for f32."""
        if self.compute_dtype == "bfloat16":
            return torch.bfloat16
        return None
