"""Node-memory state (counterpart of ``zebra_tpu/models/memory.py``).

Five per-node tensors; the pending-message flag is the last column of
``messages`` (nonzero ⇔ a message is pending), as in the JAX layout. The
port updates these tensors in place (the JAX package returns new arrays and
donates the old ones): the tables are the largest state the server holds,
and in-place scatters keep one copy of them."""

from __future__ import annotations

from typing import NamedTuple

import torch

from zebra_tpu_torch.device import resolve_device


class MemoryState(NamedTuple):
    memory: torch.Tensor       # f32|bf16 [N, mem_dim]
    last_update: torch.Tensor  # f32 [N]
    messages: torch.Tensor     # f32|bf16 [N, W+1]; last column = pending flag
    msg_ts: torch.Tensor       # f32 [N] latest pending-message timestamp
    msg_count: torch.Tensor    # f32 [N] pending count


def init_memory(n_nodes: int, mem_dim: int, msg_dim: int,
                msg_dtype=torch.bfloat16, mem_dtype=torch.float32,
                device=None) -> MemoryState:
    """Zero state; ``msg_dim`` excludes the flag column."""
    dev = resolve_device(device)
    zeros = lambda shape, dt=torch.float32: torch.zeros(shape, dtype=dt,
                                                        device=dev)
    return MemoryState(
        memory=zeros((n_nodes, mem_dim), mem_dtype),
        last_update=zeros((n_nodes,)),
        messages=zeros((n_nodes, msg_dim + 1), msg_dtype),
        msg_ts=zeros((n_nodes,)),
        msg_count=zeros((n_nodes,)),
    )
