"""Eval-mode building blocks of the step (counterpart of the eval subset of
``zebra_tpu/train/step.py``): the diffusion eval forward, the batch's raw
messages, and the fused ``last``-aggregator store+commit.

EVAL protocol (reference tgn_model.py:159-172): raw memory everywhere, no
lazy update; a batch's messages are built from pre-commit memory and
committed straight away. Training (lazy updates, loss, optimizer) is not
ported yet."""

from __future__ import annotations

import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.index.streaming import TpprQueries
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import (
    cell_apply,
    diffusion_embed,
    diffusion_static_input,
    message_cell_input,
)
from zebra_tpu_torch.models.time_encoding import time_basis, time_encode


def _forward(cfg: Config, params, mem: MemoryState, edge_feats: torch.Tensor,
             nodes: torch.Tensor, q: TpprQueries) -> torch.Tensor:
    """Eval-mode diffusion embeddings of the query rows ``nodes`` [Q] with
    their T-PPR queries ``q`` (fields [M, Q, k]) → [Q, H]."""
    src_rows = mem.memory[nodes]
    nbr_rows = mem.memory[q.nbr]
    nbr_static = diffusion_static_input(cfg, edge_feats, q.eidx, q.dt)
    return diffusion_embed(cfg, params, src_rows, nbr_rows, nbr_static, q.w)


def _build_messages(cfg: Config, mem: MemoryState, edge_feats, src, dst, t,
                    eidx, valid):
    """This batch's raw messages in the stored (compact) layout, both
    directions, with the sender/time vectors and the last-per-sender winner
    mask → (snd, t2, valid2, keep, msg [2b, msg_table_dim] f32)."""
    n = mem.memory.shape[0]
    snd = torch.cat([src, dst]).to(torch.int64)
    rcv = torch.cat([dst, src]).to(torch.int64)
    t2 = torch.cat([t, t])
    e2 = torch.cat([eidx, eidx])
    valid2 = torch.cat([valid, valid])
    pos = torch.arange(snd.shape[0], dtype=torch.int64, device=snd.device)

    # last-wins: the largest batch position per sender is the winner
    # (JAX's .at[].max(pos, mode="drop")); invalid rows land in a spare
    # slot n that is never read back
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=snd.device)
    winner.scatter_reduce_(0, torch.where(valid2, snd, n), pos, "amax",
                           include_self=True)
    keep = valid2 & (winner[snd] == pos)

    basis = time_basis(cfg.time_dim, edge_feats.device)
    # fresh edge ids past the feature table read the zero row 0
    e_safe = torch.where(e2 < edge_feats.shape[0], e2, 0)
    msg = torch.cat([
        mem.memory[rcv].float(),
        edge_feats[e_safe],
        time_encode(t2 - mem.last_update[snd], basis),
    ], dim=-1)
    return snd, t2, valid2, keep, msg


def eval_store_commit(cfg: Config, params, mem: MemoryState, edge_feats,
                      src, dst, t, eidx, valid) -> MemoryState:
    """Fused eval-batch store+commit for the ``last`` aggregator: every
    committed positive is a sender of this batch, so its cell input is this
    batch's winner message, rounded through ``messages.dtype`` as the
    two-step path's table round trip would. Winners write memory,
    last_update and msg_ts; every valid sender's message row and count are
    cleared. Updates ``mem`` in place and returns it.

    Dropped indices: JAX scatters with ``mode="drop"``; here the masks
    select the rows to write (``nonzero``), and winner rows are unique, so
    the writes are order-free. Duplicate valid senders clear their rows to
    the same zeros, which is order-free too."""
    snd, t2, valid2, keep, msg = _build_messages(
        cfg, mem, edge_feats, src, dst, t, eidx, valid)
    rows = mem.memory[snd]
    raw = msg.to(mem.messages.dtype)
    cell_in = message_cell_input(cfg, params, raw, rows)
    upd = cell_apply(cfg, params, cell_in, rows).to(mem.memory.dtype)

    win = keep.nonzero().squeeze(1)
    snd_w = snd[win]
    snd_v = snd[valid2.nonzero().squeeze(1)]
    mem.memory[snd_w] = upd[win]
    mem.last_update[snd_w] = t2[win]
    mem.msg_ts[snd_w] = t2[win]
    mem.messages[snd_v] = 0.0
    mem.msg_count[snd_v] = 0.0
    return mem
