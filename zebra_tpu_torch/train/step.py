"""Building blocks of the train and eval step (counterpart of
``zebra_tpu/train/step.py``): every tower (diffusion here, the others in
``models/embedding.py``), both aggregators, memory- or embedding-sourced
messages, and per-position or compacted lazy updates.

TRAIN batch (one-batch message staleness):
  1. differentiable forward with lazy memory: a selected neighbor row with a
     pending message goes through the updater cell on the fly, without
     committing; a query row (src/dst/neg) does so only when its node is
     also a selected neighbor;
  2. BCE(pos, 1) + BCE(neg, 0) as masked means, backward, Adam step;
  3. no grad: commit the pending messages of the batch's positives with the
     updated parameters, then store this batch's messages (both
     directions) from the post-commit memory: the last per sender wins
     (``last``), or every message adds into its sender's row (``mean``,
     whose commit divides by the count). Under a message-source flag the
     sender or receiver part of a message is the batch's (detached)
     embedding instead of the memory row.

EVAL batch: raw memory everywhere; the batch's messages are stored and
committed at once: fused under ``last`` (:func:`eval_store_commit`), store
then commit under ``mean``. A flush of every pending message
(:func:`flush_pending`) runs at the train→eval transition.

LAZY COMPACTION (``cfg.lazy_unique_cap`` ≠ 0, the diffusion tower): the
updater cell runs once per distinct selected node of a batch, at most a
static cap of them, instead of once per position (:func:`make_lazy_plan`).
The plan sorts, ranks by a cumsum and bounds the segments by a binary
search, so every batch has the same shapes and nothing is read back; a
batch with more distinct nodes than the cap raises the plan's
``overflow`` flag on the device, and the Trainer reruns the epoch per
position. A row-sharded block plans with the whole batch's membership and
flag and compacts its own positions (:func:`block_lazy_plan`).

SEED-PARALLEL (``cfg.parallel_runs`` = S > 1; the counterpart of the JAX
package's ``*_flat`` helpers, ``zebra_tpu/train/step.py:544-718``): the
parameters carry a leading [S] axis and the memory tables are carried flat,
[S·N, ...], seed s owning rows [s·N, (s+1)·N). Every function here takes
``offs`` (i64 [S], s·N; None for one seed): ids are moved into each lane's
rows in int64 after the queries are unpacked (:func:`lane_ids`), never
inside the f32 index rows, so S·N may pass 2^24. The forward and the
memory protocol then run all lanes in one set of operations; the last-wins
winner of a sender does not depend on the seed and is computed once.

The memory tables are updated in place, under ``torch.no_grad()``; the
gradients reach the parameters, never the tables. ``valid`` None means
every event of the batch is valid: each scatter then writes every row it
touches, duplicates with equal values, so nothing is read back from the
device. A ``valid`` mask selects the rows to write with ``nonzero``, which
reads a count back (the trainer passes masks only for the padded tail of
a stream; serving's ``observe`` passes none, every observed event being
valid)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.index.neighbor_finder import NeighborIndex
from zebra_tpu_torch.index.streaming import TpprQueries
from zebra_tpu_torch.models.embedding import lane_ids, lazy_rows, tower_embed
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import (
    affinity_score,
    cell_apply,
    diffusion_embed,
    diffusion_static_input,
    lane_params,
    message_cell_input,
    message_input,
)
from zebra_tpu_torch.models.time_encoding import time_basis, time_encode


class Stream(NamedTuple):
    """A phase's events, padded to whole batches, on the device."""

    src: torch.Tensor    # i32 [E]
    dst: torch.Tensor    # i32 [E]
    neg: torch.Tensor    # i32 [E] negative node per event ([E, S]: one per
                         # seed, seed-parallel training)
    t: torch.Tensor      # f32 [E]
    eidx: torch.Tensor   # i32 [E]
    valid: torch.Tensor  # bool [E]


def lane_lrs(cfg: Config, lanes: Optional[Sequence[int]] = None):
    """The lr of each seed lane of ``lanes`` (global ids; every lane by
    default): ``cfg.parallel_lr``, or ``cfg.lr`` for every seed when
    unset."""
    lrs = cfg.parallel_lr or (cfg.lr,) * cfg.n_seeds
    return tuple(lrs[g] for g in (range(cfg.n_seeds) if lanes is None
                                  else lanes))


def make_optimizer(cfg: Config, params,
                   lanes: Optional[Sequence[int]] = None):
    """``optax.adam(cfg.lr)``: the same update rule, with the moments on the
    parameters' device. Stacked parameters (S > 1 seeds) get a
    :class:`SeedAdam` at :func:`lane_lrs` of ``lanes``, the global seed
    lanes they hold (all S by default)."""
    if cfg.n_seeds > 1:
        return SeedAdam(params, lane_lrs(cfg, lanes))
    return torch.optim.Adam(params.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


class SeedAdam:
    """Adam over stacked parameters [S, ...], lane s at its own lr.

    ``torch.optim.Adam`` holds one lr per parameter group, and a group per
    seed would step each seed with its own set of operations. Here every
    stacked leaf and its two moments are split once into S lane views, and
    one step is ``torch.optim.Adam``'s foreach update on those views: the
    same operations in the same order, with the step size of lane s from
    ``lrs[s]``. Lane s therefore steps as a single-seed Adam at ``lrs[s]``
    does (the foreach update on the card, and on the CPU, where foreach
    runs the single-tensor update tensor by tensor), with about as many
    operations as one seed's step. All lanes step together, so one step
    count serves them."""

    def __init__(self, params, lrs: Sequence[float],
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params.parameters())
        self.lrs = tuple(float(x) for x in lrs)
        if any(p.shape[0] != len(self.lrs) for p in self.params):
            raise ValueError(f"every parameter needs a leading seed axis of "
                             f"{len(self.lrs)} lanes")
        self.betas, self.eps = betas, eps
        self.steps = 0
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        lanes = lambda ts: [v for t in ts for v in t.unbind(0)]
        # views without autograd history: one would keep each parameter's
        # gradient accumulator alive on the stream it was made on, which a
        # CUDA graph's backward on another stream cannot use
        with torch.no_grad():
            self._p, self._m, self._v = (lanes(ts) for ts in (
                self.params, self.exp_avg, self.exp_avg_sq))
        self._lr = [lr for _ in self.params for lr in self.lrs]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [v for p in self.params for v in p.grad.unbind(0)]
        beta1, beta2 = self.betas
        self.steps += 1
        torch._foreach_lerp_(self._m, grads, 1 - beta1)
        torch._foreach_mul_(self._v, beta2)
        torch._foreach_addcmul_(self._v, grads, grads, 1 - beta2)
        bc1, bc2 = 1 - beta1 ** self.steps, 1 - beta2 ** self.steps
        denom = torch._foreach_sqrt(self._v)
        torch._foreach_div_(denom, [bc2 ** 0.5] * len(denom))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self._p, self._m, denom,
                                [(lr / bc1) * -1 for lr in self._lr])

    def state_dict(self) -> dict:
        return {"steps": self.steps, "lrs": list(self.lrs),
                "exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq}

    def load_state_dict(self, state: dict) -> None:
        """Load in place, so the lane views keep referring to the live
        moments."""
        if tuple(state["lrs"]) != self.lrs:
            raise ValueError(f"the state's per-seed lrs {state['lrs']} are "
                             f"not this optimizer's {list(self.lrs)}")
        for live, saved in zip(self.exp_avg + self.exp_avg_sq,
                               state["exp_avg"] + state["exp_avg_sq"]):
            live.copy_(saved)
        self.steps = int(state["steps"])


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 count: Optional[int] = None) -> torch.Tensor:
    """Mean of ``x`` over its last axis where ``mask`` holds; with
    ``count`` (a row-sharded block, known on the host), the sum over this
    block's valid entries divided by the whole batch's valid count."""
    if count is not None:
        return torch.where(mask, x, 0.0).sum(-1) / count
    return torch.where(mask, x, 0.0).sum(-1) / mask.sum().clamp(min=1)


# ------------------------------------------------------------------ forward

class LazyPlan(NamedTuple):
    """Id bookkeeping of the train forward's lazy updates
    (``zebra_tpu/train/step.py:LazyPlan``), made outside the differentiated
    part. Fields carry a leading lane axis for seed-parallel ids; ``uniq``
    and the fields after it are None in per-position mode."""

    in_sel: torch.Tensor          # bool [3b]: query node among the selected
    overflow: torch.Tensor        # f32 []: 1.0 when a lane's distinct count
                                  # passed the cap (its rows are then wrong)
    uniq: Optional[torch.Tensor] = None        # i64 [cap] sorted distinct
                                               # ids, padded with BIG
    gather_ids: Optional[torch.Tensor] = None  # i64 [cap] uniq, pad → 0
    jn: Optional[torch.Tensor] = None          # i64 [M, 3b, k] position →
                                               # slot
    j3: Optional[torch.Tensor] = None          # i64 [3b] query → slot
    perm: Optional[torch.Tensor] = None        # i64 [P] id-sorted positions
    start_pos: Optional[torch.Tensor] = None   # i64 [cap] segment starts
    end_pos: Optional[torch.Tensor] = None     # i64 [cap] segment ends


def lazy_position_count(cfg: Config) -> int:
    """Selected-neighbor positions of one train batch's lazy update (per
    lane): the [M, 3b, k] layout of ``q.nbr`` that :func:`make_lazy_plan`
    reads. The Trainer's snapshot gate derives its decision from the same
    count; :func:`make_lazy_plan` checks that the two agree."""
    return cfg.n_tppr * 3 * cfg.bs * cfg.topk


def resolve_lazy_cap(cfg: Config, n_positions: int) -> int:
    """The static distinct-row budget: ``cfg.lazy_unique_cap``, -1 meaning
    auto (2/5 of the position count, at least 256); 0 when the cap would
    not shrink anything."""
    cap = cfg.lazy_unique_cap
    if cap < 0:
        cap = max(256, (2 * n_positions) // 5)
    if cap >= n_positions:
        return 0
    return cap


def make_lazy_plan(cfg: Config, q: TpprQueries, nodes3) -> LazyPlan:
    """The lazy-update plan of a train batch. Per position (cap 0): whether
    each query node [3b] is among the selected neighbors (the membership
    that gates its lazy update), by a sort of the selected ids and a binary
    search. Compacted (``resolve_lazy_cap`` > 0): the selected ids of each
    lane sorted, their ranks from a cumsum over the new-id mask, the
    position → slot map by inverting the sort's permutation, the segment
    bounds by a binary search of the ranks, and the sorted distinct ids
    padded to the static cap. Seed-parallel ids ([S, M, 3b, k], [S, 3b])
    plan each lane alone, as a single-seed batch would."""
    n_pos = q.nbr.shape[-3:].numel()
    if n_pos != lazy_position_count(cfg):
        raise ValueError(
            "query layout desynced from lazy_position_count "
            f"({n_pos} positions vs {lazy_position_count(cfg)}): the "
            "Trainer's overflow-snapshot gate keys off that count")
    cap = resolve_lazy_cap(cfg, n_pos)
    if not cap:
        flat = torch.sort(q.nbr.reshape(-1)).values
        j = torch.searchsorted(flat, nodes3).clamp(max=flat.numel() - 1)
        return LazyPlan(in_sel=flat[j] == nodes3,
                        overflow=torch.zeros((), device=flat.device))

    lead = q.nbr.shape[:-3]
    ids = q.nbr.reshape(-1, n_pos).to(torch.int64)           # [L, P]
    seg = _compaction(ids, cap)
    nodes = nodes3.reshape(seg.uniq.shape[0], -1).to(torch.int64)
    j3 = torch.searchsorted(seg.uniq, nodes).clamp(max=cap - 1)
    in_sel = seg.uniq.gather(-1, j3) == nodes
    out = dict(uniq=seg.uniq, gather_ids=torch.where(seg.live, seg.uniq, 0),
               j3=j3, perm=seg.perm, start_pos=seg.start_pos,
               end_pos=seg.end_pos)
    return LazyPlan(
        in_sel=in_sel.reshape(nodes3.shape),
        overflow=(seg.n_unique > cap).any().float(),
        jn=seg.jn.clamp(max=cap - 1).reshape(q.nbr.shape),
        **{k: v.reshape(lead + v.shape[1:]) for k, v in out.items()})


class _Segments(NamedTuple):
    """The compaction of id lanes [L, P] at a static cap (fields [L, ·])."""

    uniq: torch.Tensor        # i64 [L, cap] sorted distinct ids, BIG-padded
    live: torch.Tensor        # bool [L, cap] the slots that hold an id
    n_unique: torch.Tensor    # i64 [L]
    jn: torch.Tensor          # i64 [L, P] position → slot (unclamped)
    perm: torch.Tensor        # i64 [L, P] id-sorted positions
    start_pos: torch.Tensor   # i64 [L, cap] segment starts
    end_pos: torch.Tensor     # i64 [L, cap] segment ends


def _compaction(ids: torch.Tensor, cap: int) -> _Segments:
    """Each lane's ids sorted, their ranks from a cumsum over the new-id
    mask, the position → slot map by inverting the sort's permutation, the
    segment bounds by a binary search of the ranks, and the sorted distinct
    ids padded to ``cap``."""
    n_lanes, n_pos = ids.shape
    dev = ids.device
    flat, perm = torch.sort(ids, dim=-1, stable=True)
    is_new = torch.ones_like(flat, dtype=torch.bool)
    is_new[:, 1:] = flat[:, 1:] != flat[:, :-1]
    rank = torch.cumsum(is_new, dim=-1) - 1                  # [L, P]
    n_unique = rank[:, -1] + 1                               # [L]
    jn = torch.empty_like(rank).scatter_(-1, perm, rank)     # undo the sort
    r = torch.arange(cap, device=dev).expand(n_lanes, cap).contiguous()
    end_pos = torch.searchsorted(rank, r, right=True)        # [L, cap]
    start_pos = torch.zeros_like(end_pos)
    start_pos[:, 1:] = end_pos[:, :-1]
    live = r < n_unique[:, None]
    big = torch.iinfo(torch.int64).max
    uniq = torch.where(live, flat.gather(-1, start_pos.clamp(max=n_pos - 1)),
                       big)
    return _Segments(uniq, live, n_unique, jn, perm, start_pos, end_pos)


def block_lazy_plan(cfg: Config, every: TpprQueries, nodes,
                    block_nbr: torch.Tensor,
                    local_nbr: torch.Tensor) -> LazyPlan:
    """The lazy plan of one row-sharded block of a train batch. ``every``
    holds the whole batch's queries (global ids, [M, 3b, k]) and ``nodes``
    the block's query nodes (global ids, [3b']): the membership that gates
    a query row's update and the overflow flag are the whole batch's, as
    one process decides them. Compacted, the block's own selected
    positions ``block_nbr`` (global ids, [M, 3b', k]) take the whole
    batch's cap; each distinct id's row is the first of its positions in
    the block's table (``local_nbr``, the positions' local rows), and the
    query rows update per position (``j3`` None), since the cell's row of
    a query node may lie outside the block's positions."""
    whole = make_lazy_plan(cfg, every, nodes)
    if whole.uniq is None:
        return whole
    cap = whole.uniq.shape[-1]
    ids = block_nbr.reshape(1, -1).to(torch.int64)
    seg = _compaction(ids, cap)
    first = seg.perm.gather(-1, seg.start_pos.clamp(max=ids.shape[1] - 1))
    rows = torch.where(seg.live, local_nbr.reshape(1, -1).gather(-1, first),
                       0)
    return LazyPlan(in_sel=whole.in_sel, overflow=whole.overflow,
                    uniq=seg.uniq[0], gather_ids=rows[0],
                    jn=seg.jn.clamp(max=cap - 1).reshape(block_nbr.shape),
                    perm=seg.perm[0], start_pos=seg.start_pos[0],
                    end_pos=seg.end_pos[0])


def _lane_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[idx]`` per lane: rows [*lead, n, D], idx [*lead, ...] →
    [*lead, ..., D] (lead () or (S,))."""
    if rows.dim() == 2:
        return rows[idx]
    lanes = torch.arange(rows.shape[0], device=rows.device)
    return rows[lanes.view((-1,) + (1,) * (idx.dim() - 1)), idx]


class DedupGather(torch.autograd.Function):
    """``rows_u[jn]`` (per lane) whose backward is JAX's sorted-segment sum
    (``zebra_tpu/train/step.py:_dedup_gather``): the cotangents in id order,
    a cumsum, then differences at the segment bounds, in place of the
    scatter-add of the gather's own backward. The backward works on the
    cotangents transposed to [lanes, D, positions], so the cumsum runs
    along the innermost axis: along an outer axis of [1, 24,000, 100] the
    card's scan took 4.2 ms per batch."""

    @staticmethod
    def forward(ctx, rows_u, jn, perm, start_pos, end_pos):
        ctx.save_for_backward(perm, start_pos, end_pos)
        ctx.shape = rows_u.shape
        return _lane_gather(rows_u, jn)

    @staticmethod
    def backward(ctx, g):
        perm, start_pos, end_pos = ctx.saved_tensors
        d = g.shape[-1]
        n_lanes = perm.numel() // perm.shape[-1]
        g = g.reshape(n_lanes, -1, d).transpose(1, 2)         # [L, D, P]
        pick = lambda x, i: x.gather(
            2, i.reshape(n_lanes, 1, -1).expand(-1, d, -1))
        c = torch.cumsum(pick(g, perm), dim=-1)
        cpad = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
        d_rows = pick(cpad, end_pos) - pick(cpad, start_pos)  # [L, D, cap]
        return (d_rows.transpose(1, 2).reshape(ctx.shape), None, None, None,
                None)


def _train_lazy_rows(cfg: Config, params, mem: MemoryState, nodes3,
                     q: TpprQueries, plan: LazyPlan):
    """The lazily updated rows of the train forward: the 3b query rows
    (updated when ``plan.in_sel``) and the [M, 3b, k] selected-neighbor
    rows (always updated). With a compaction plan the cell runs once per
    distinct selected node (``plan.gather_ids``) and the positions gather
    their node's row; a query row in the selected set takes its slot's."""
    if plan.uniq is None:
        src_rows = lazy_rows(cfg, params, mem, nodes3, plan.in_sel)
        nbr_rows = lazy_rows(cfg, params, mem, q.nbr,
                             torch.ones_like(q.nbr, dtype=torch.bool))
        return src_rows, nbr_rows
    rows_u = lazy_rows(cfg, params, mem, plan.gather_ids,
                       torch.ones_like(plan.gather_ids, dtype=torch.bool))
    nbr_rows = DedupGather.apply(rows_u, plan.jn, plan.perm, plan.start_pos,
                                 plan.end_pos)
    if plan.j3 is None:         # a row-sharded block (block_lazy_plan)
        return lazy_rows(cfg, params, mem, nodes3, plan.in_sel), nbr_rows
    src_rows = torch.where(plan.in_sel[..., None],
                           _lane_gather(rows_u, plan.j3), mem.memory[nodes3])
    return src_rows, nbr_rows


def _lane_moved(q: TpprQueries, nodes, offs):
    """The diffusion tower's query and row ids moved into each lane's rows
    (unchanged for one seed, ``offs`` None)."""
    if offs is None:
        return q, nodes
    return (q._replace(nbr=lane_ids(q.nbr, offs, shared=q.nbr.dim() == 3)),
            lane_ids(nodes, offs, shared=nodes.dim() == 1))


def train_plan(cfg: Config, q: Optional[TpprQueries], nodes,
               offs=None) -> Optional[LazyPlan]:
    """The lazy-update plan of a train batch of the diffusion tower (None
    for the other towers), for :func:`_forward`'s ``plan``."""
    if not cfg.uses_tppr:
        return None
    return make_lazy_plan(cfg, *_lane_moved(q, nodes, offs))


def _forward(cfg: Config, params, mem: MemoryState, edge_feats: torch.Tensor,
             nodes: torch.Tensor, q: Optional[TpprQueries], train: bool = False,
             generator=None, offs=None, times: Optional[torch.Tensor] = None,
             nbr_index: Optional[NeighborIndex] = None,
             plan: Optional[LazyPlan] = None) -> torch.Tensor:
    """Embeddings of the query rows ``nodes`` [Q] → [Q, H], by the tower of
    ``cfg.embedding_module``. Diffusion reads the rows' T-PPR queries ``q``
    (fields [M, Q, k]); the other towers read the query ``times`` [Q] and,
    the recursive ones, the adjacency index ``nbr_index``
    (``models/embedding.py``). Train mode reads lazily updated memory and
    applies the diffusion tower's dropout with masks from ``generator``.

    Seed-parallel (``offs``): stacked parameters and flat tables, ``nodes``
    and ``q`` shared by the lanes ([Q], [M, Q, k]) or per lane ([S, Q],
    [S, M, Q, k]) → [S, Q, H]; ``generator`` is one generator per lane.
    The diffusion tower's lazy plan then sorts all lanes' row ids in one
    sort. A train-mode caller may pass the ``plan``
    (:func:`make_lazy_plan` of the lane-moved ids) it made itself."""
    if not cfg.uses_tppr:
        return tower_embed(cfg, params, mem, edge_feats, nbr_index, nodes,
                           times, train, offs)
    q, nodes = _lane_moved(q, nodes, offs)
    if train:
        if plan is None:
            plan = make_lazy_plan(cfg, q, nodes)
        src_rows, nbr_rows = _train_lazy_rows(cfg, params, mem, nodes, q,
                                              plan)
    else:
        src_rows, nbr_rows = mem.memory[nodes], mem.memory[q.nbr]
    nbr_static = diffusion_static_input(cfg, edge_feats, q.eidx, q.dt)
    return diffusion_embed(cfg, params, src_rows, nbr_rows, nbr_static, q.w,
                           generator if train else None)


def _scores(cfg: Config, params, emb: torch.Tensor, b: int):
    """Link logits of src against dst and against neg → (pos, neg) [b]
    ([S, b] each for stacked parameters and emb [S, 3b, H])."""
    e_src, e_dst, e_neg = (emb[..., :b, :], emb[..., b: 2 * b, :],
                           emb[..., 2 * b:, :])
    logits = affinity_score(params, torch.cat([e_src, e_src], dim=-2),
                            torch.cat([e_dst, e_neg], dim=-2), cfg.mxu_dtype)
    return logits[..., :b], logits[..., b:]


# ------------------------------------------------------------------ memory protocol

def _selected(mask):
    """Positions where ``mask`` holds (``nonzero``: reads the count back),
    or None for a mask of None (every position)."""
    return None if mask is None else mask.nonzero().squeeze(1)


@torch.no_grad()
def _commit_pending(cfg: Config, params, mem: MemoryState, positives,
                    valid2=None, offs=None) -> MemoryState:
    """Commit the pending messages of the batch's positives [2b] and clear
    their message rows, in place. Duplicate positives compute equal values,
    so the order of their writes does not matter."""
    positives = lane_ids(positives, offs)
    rows = mem.memory[positives]
    msg, flag = message_input(cfg, params, mem, positives, rows)
    if valid2 is not None:
        flag = flag & valid2
    upd = cell_apply(cfg, params, msg, rows).to(mem.memory.dtype)
    new_memory = torch.where(flag[..., None], upd, rows)
    new_last = torch.where(flag, mem.msg_ts[positives],
                           mem.last_update[positives])
    sel = _selected(valid2)
    if sel is not None:
        positives, new_memory, new_last = (
            positives[..., sel], new_memory[..., sel, :], new_last[..., sel])
    mem.memory[positives] = new_memory
    mem.last_update[positives] = new_last
    # device scalars: a Python number is copied in from the host, which
    # waits for the device and cannot be captured in a CUDA graph
    mem.messages[positives] = mem.messages.new_zeros(())
    mem.msg_count[positives] = mem.msg_count.new_zeros(())
    return mem


def _build_messages(cfg: Config, mem: MemoryState, edge_feats, src, dst, t,
                    eidx, valid, offs=None, src_emb=None, dst_emb=None):
    """This batch's raw messages in the stored layout, both directions →
    (snd, t2, valid2, win, msg [2b, msg_table_dim] f32). The compact layout
    omits the sender part; under use_source_embedding_in_message it is the
    sender's embedding, and under use_destination_embedding_in_message the
    receiver part is the receiver's embedding instead of its memory row
    (``src_emb``/``dst_emb`` [b, H]: the batch's src and dst embeddings,
    [S, b, H] per lane). ``win`` [2b] is the batch position of the last
    valid message of each position's sender (the winner; -1 where the
    sender sent none). With ``offs``, snd [S, 2b] holds each lane's rows
    and msg is [S, 2b, ·]; t2, valid2 and win are the lanes' shared ones."""
    n = mem.memory.shape[0] // (1 if offs is None else offs.shape[0])
    snd = torch.cat([src, dst]).to(torch.int64)
    rcv = torch.cat([dst, src]).to(torch.int64)
    t2 = torch.cat([t, t])
    e2 = torch.cat([eidx, eidx])
    valid2 = None if valid is None else torch.cat([valid, valid])
    pos = torch.arange(snd.shape[0], dtype=torch.int64, device=snd.device)

    # last-wins: the largest batch position per sender; invalid rows land in
    # a spare slot n that is never read back
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=snd.device)
    tgt = snd if valid2 is None else torch.where(valid2, snd, n)
    winner.scatter_reduce_(0, tgt, pos, "amax", include_self=True)

    win = winner[snd]
    snd, rcv = lane_ids(snd, offs), lane_ids(rcv, offs)
    both = lambda a, b: torch.cat([a, b], dim=-2).float()
    parts = []
    if cfg.use_source_embedding_in_message:
        parts.append(both(src_emb, dst_emb))
    if cfg.use_destination_embedding_in_message:
        parts.append(both(dst_emb, src_emb))
    else:
        parts.append(mem.memory[rcv].float())
    basis = time_basis(cfg.time_dim, edge_feats.device)
    # fresh edge ids past the feature table read the zero row 0
    e_safe = torch.where(e2 < edge_feats.shape[0], e2, 0)
    feats = edge_feats[e_safe]
    msg = torch.cat(parts + [
        feats.expand(snd.shape + feats.shape[-1:]),
        time_encode(t2 - mem.last_update[snd], basis),
    ], dim=-1)
    return snd, t2, valid2, win, msg


def _winner_writes(snd, valid2, win):
    """(rows, positions): the table rows a last-wins scatter writes and the
    batch positions whose values they take. All valid: every sender writes
    its winner's values. With a mask: the winners alone."""
    if valid2 is None:
        return snd, win
    pos = torch.arange(snd.shape[-1], device=snd.device)
    keep = _selected(valid2 & (win == pos))
    return snd[..., keep], keep


def stored_messages(cfg: Config, mem: MemoryState, edge_feats, src, dst, t,
                    eidx, valid=None, offs=None, src_emb=None, dst_emb=None):
    """This batch's messages as the table stores them, both directions:
    :func:`_build_messages` with the pending flag (a last column of ones)
    in ``messages.dtype`` → (snd, t2, valid2, win, rows [2b, msg_table_dim
    + 1])."""
    snd, t2, valid2, win, msg = _build_messages(
        cfg, mem, edge_feats, src, dst, t, eidx, valid, offs, src_emb,
        dst_emb)
    one = torch.ones(msg.shape[:-1] + (1,), dtype=msg.dtype,
                     device=msg.device)
    msg = torch.cat([msg, one], dim=-1).to(mem.messages.dtype)
    return snd, t2, valid2, win, msg


@torch.no_grad()
def accumulate_messages(mem: MemoryState, snd, msg, t2) -> MemoryState:
    """The ``mean`` store of stored message rows ``msg`` [..., n, W] into
    their senders' rows ``snd`` [..., n], in place: each adds into its row
    in the table's dtype, ``msg_count`` adds one per message and ``msg_ts``
    keeps the newest of ``t2`` [n]. The additions of one row run in the
    order given, on the CPU and (the sort-based ``index_put_``) on the
    card."""
    rows = snd.reshape(-1)
    ones = torch.ones(rows.shape, device=rows.device)
    mem.messages.index_put_((rows,), msg.reshape(-1, msg.shape[-1]),
                            accumulate=True)
    mem.msg_count.index_put_((rows,), ones, accumulate=True)
    mem.msg_ts.scatter_reduce_(0, rows, t2.expand(snd.shape).reshape(-1),
                               "amax", include_self=True)
    return mem


@torch.no_grad()
def _store_messages(cfg: Config, params, mem: MemoryState, edge_feats, src,
                    dst, t, eidx, valid=None, offs=None, src_emb=None,
                    dst_emb=None) -> MemoryState:
    """Store this batch's messages, both directions, in place, with the
    pending flag (last column) set. ``last``: the chronologically last per
    sender overwrites its row. ``mean``: every valid message adds into its
    sender's row in batch order (:func:`accumulate_messages`)."""
    snd, t2, valid2, win, msg = stored_messages(
        cfg, mem, edge_feats, src, dst, t, eidx, valid, offs, src_emb,
        dst_emb)
    if cfg.aggregator == "mean":
        sel = _selected(valid2)
        if sel is not None:
            snd, msg, t2 = snd[..., sel], msg[..., sel, :], t2[sel]
        return accumulate_messages(mem, snd, msg, t2)
    rows, take = _winner_writes(snd, valid2, win)
    mem.messages[rows] = msg[..., take, :]
    mem.msg_ts[rows] = t2[take]
    mem.msg_count[rows] = mem.msg_count.new_ones(())   # a device scalar
    return mem


@torch.no_grad()
def eval_store_commit(cfg: Config, params, mem: MemoryState, edge_feats,
                      src, dst, t, eidx, valid=None, offs=None, src_emb=None,
                      dst_emb=None) -> MemoryState:
    """Fused eval-batch store+commit for the ``last`` aggregator: every
    committed positive is a sender of this batch, so its cell input is this
    batch's winner message, rounded through ``messages.dtype`` as the
    two-step path's table round trip would. Winners write memory,
    last_update and msg_ts; every valid sender's message row and count are
    cleared. Updates ``mem`` in place and returns it. ``valid`` None (a
    full trainer batch, every ``observe`` of serving) writes every sender's
    rows with its winner's values and reads nothing back, so the protocol
    can be captured in a CUDA graph. ``mean`` accumulates over the rows
    pending before the batch, so it takes :func:`eval_store_then_commit`."""
    if cfg.aggregator != "last":
        raise ValueError(
            f"eval_store_commit fuses the last-aggregator protocol; "
            f"aggregator={cfg.aggregator!r} stores then commits")
    snd, t2, valid2, win, msg = _build_messages(
        cfg, mem, edge_feats, src, dst, t, eidx, valid, offs, src_emb,
        dst_emb)
    rows = mem.memory[snd]
    raw = msg.to(mem.messages.dtype)
    cell_in = message_cell_input(cfg, params, raw, rows)
    upd = cell_apply(cfg, params, cell_in, rows).to(mem.memory.dtype)

    rows_w, take = _winner_writes(snd, valid2, win)
    sel = _selected(valid2)
    snd_v = snd if sel is None else snd[..., sel]
    mem.memory[rows_w] = upd[..., take, :]
    mem.last_update[rows_w] = t2[take]
    mem.msg_ts[rows_w] = t2[take]
    mem.messages[snd_v] = mem.messages.new_zeros(())    # device scalars
    mem.msg_count[snd_v] = mem.msg_count.new_zeros(())
    return mem


def eval_store_then_commit(cfg: Config, params, mem: MemoryState, edge_feats,
                           src, dst, t, eidx, valid=None, offs=None,
                           src_emb=None, dst_emb=None) -> MemoryState:
    """The eval protocol of a batch, unfused: store its messages, then
    commit its positives' pending rows (JAX's path under ``mean``, and of
    the node-classification replay)."""
    _store_messages(cfg, params, mem, edge_feats, src, dst, t, eidx, valid,
                    offs, src_emb, dst_emb)
    valid2 = None if valid is None else torch.cat([valid, valid])
    return _commit_pending(cfg, params, mem, torch.cat([src, dst]), valid2,
                           offs)


def eval_protocol(cfg: Config, params, mem: MemoryState, edge_feats, src, dst,
                  t, eidx, valid=None, offs=None, src_emb=None,
                  dst_emb=None) -> MemoryState:
    """The eval protocol of a batch: fused under ``last``
    (:func:`eval_store_commit`), store then commit under ``mean``."""
    fn = (eval_store_commit if cfg.aggregator == "last"
          else eval_store_then_commit)
    return fn(cfg, params, mem, edge_feats, src, dst, t, eidx, valid, offs,
              src_emb, dst_emb)


@torch.no_grad()
def flush_pending(cfg: Config, params, mem: MemoryState) -> MemoryState:
    """The train→eval flush of every pending message, dense over the N rows
    (``flush_pending_impl``). Returns a new state and leaves ``mem`` as it
    was, so ``mem`` can stay the pre-flush backup."""
    out = MemoryState(*(x.clone() for x in mem))
    return flush_pending_(cfg, params, out)


@torch.no_grad()
def flush_pending_(cfg: Config, params, mem: MemoryState) -> MemoryState:
    """:func:`flush_pending` in place: the host-backup protocol's flush,
    whose backup lives in host memory. Returns ``mem``."""
    msg, flag = message_input(cfg, params, mem, None)
    upd = cell_apply(cfg, params, msg, mem.memory).to(mem.memory.dtype)
    mem.memory.copy_(torch.where(flag[:, None], upd, mem.memory))
    mem.last_update.copy_(torch.where(flag, mem.msg_ts, mem.last_update))
    mem.messages.zero_()
    mem.msg_count.zero_()
    return mem


@torch.no_grad()
def flush_pending_seeds(cfg: Config, params, mem: MemoryState,
                        in_place: bool = False) -> MemoryState:
    """:func:`flush_pending` of flat seed-parallel tables (the lanes
    ``params`` holds, N = ``cfg.n_nodes`` rows each), one seed at a time
    (``_flush_mem_seeds``): the dense f32 scratch of the cell stays at one
    seed's N rows. Returns new tables and leaves ``mem`` as it was, or
    flushes ``mem`` itself under ``in_place``."""
    n = cfg.n_nodes
    out = mem if in_place else MemoryState(*(x.clone() for x in mem))
    for s in range(out.memory.shape[0] // n):
        rows = slice(s * n, (s + 1) * n)
        flush_pending_(cfg, lane_params(params, s),
                       MemoryState(*(x[rows] for x in out)))
    return out
