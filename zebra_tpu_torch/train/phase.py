"""One pass over a phase's batches (counterpart of the single-seed wave
path of ``zebra_tpu/train/phase.py``): towers, loss, optimizer, memory
protocol and metrics, batch by batch. The diffusion tower reads each
batch's T-PPR queries: under the streaming strategy the rows the wave scan
extracted for the chunk (``index/waves.py``), under the pruning strategy a
bounded BFS over an adjacency index (``index/pruning.py``), one call per
batch. The other towers read no T-PPR query under either strategy: they
embed the roots at their event times, the recursive ones over the
adjacency index of the phase's graph (``models/embedding.py``).

Eager PyTorch replaces the JAX package's one ``lax.scan`` per phase: the
batches run as a Python loop that only enqueues device work. Nothing is
read back inside the loop: per-batch metrics stay on the device, and the
caller reads a phase's metrics once. A train batch is one sequence of
parts (:func:`_train_batch`): forward, backward, Adam's step, memory
protocol, metrics. The part functions run eagerly, or, for a full
streaming train batch on the card, replay as the CUDA graphs captured
from them in place of that enqueue (``train/graphs.py``).

The same loop runs S seeds in one pass (``_run_phase_seeds``,
``zebra_tpu/train/phase.py:377-558``) when given the lane offsets ``offs``:
stacked parameters, flat memory tables (``train/step.py``), one batched
forward, one ``backward()`` of the summed lane losses (the lanes share no
parameter, so each gets its own gradient), one Adam step for all lanes,
then the memory protocol for all lanes. Train lane s reads query blocks
[src, dst, neg_s]: of the shared scan's rows [E, 2+S, F], or of one BFS
call over the roots [src; dst; neg_0 … neg_{S-1}] (the BFS answers each
root on its own); eval shares the negatives and the query blocks. Only the
dropout masks are drawn lane by lane, from each seed's generator.

Row-sharded (one seed, its node rows split over D ranks:
:func:`run_phase_rows`, the counterpart of the JAX package's row-sharded
phases with ``shard_batch``'s ``P('data')``): rank r takes the event block
[r·b/D, (r+1)·b/D) of each batch. It fetches the rows its block reads
through the row exchange (``parallel/exchange.py``) into a small table of
its own: the block's nodes and their T-PPR neighbors (the streaming
extraction rows, or one BFS over the whole batch's roots on every rank),
the distinct ids of the block's hop tree (the recursive towers, the whole
batch's tree built on every rank), or the block's nodes alone (the
memory-only towers). It runs the towers and the memory protocol on that
table and sends the rows whose write it wins to their owners; under
``mean`` every block's message rows cross whole and each owner adds its
senders' in batch order. The gradients are summed over the ranks before
one Adam step, the same on every rank; the scores cross once, at the
phase's end, where the metrics are computed as in one process."""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from zebra_tpu_torch.config import RECURSIVE, Config
from zebra_tpu_torch.index.neighbor_finder import NeighborIndex
from zebra_tpu_torch.index.queries import (
    batch_queries,
    ensemble_tensors,
    pruned_queries,
)
from zebra_tpu_torch.index.streaming import TpprQueries
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import BlockMasks
from zebra_tpu_torch.ops.metrics import masked_ap, masked_auc, masked_rank_acc
from zebra_tpu_torch.models.embedding import (
    Hop,
    hop_tree,
    lane_ids,
    tree_embed,
)
from zebra_tpu_torch.train.graphs import BatchGraphs, Bound, Parts, replays
from zebra_tpu_torch.train.step import (
    LazyPlan,
    Stream,
    _commit_pending,
    _forward,
    _masked_mean,
    _scores,
    _store_messages,
    accumulate_messages,
    block_lazy_plan,
    eval_protocol,
    stored_messages,
    train_plan,
)
from zebra_tpu_torch.utils import profiling
from zebra_tpu_torch.utils.profiling import (
    ADAM,
    ALLREDUCE,
    BACKWARD,
    BATCH,
    FETCH,
    FORWARD,
    PROTOCOL,
    QUERY,
    SEND,
    part,
    span,
)

METRICS = ("loss", "ap", "auc", "acc")


class Ran(NamedTuple):
    """What a pass over a superchunk's batches hands back, on the device
    but for the seconds."""

    metrics: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
    # run_phase: the per-batch metrics [n_batches, 4] (:data:`METRICS`;
    # [n_batches, S, 4] per lane); run_phase_rows: this block's (pos, neg)
    # probabilities [n_batches, 2, b'] and loss shares [n_batches]
    bfs_s: float                  # host seconds of the batches' BFS calls
    overflow: List[torch.Tensor]  # each train batch's lazy-compaction
                                  # overflow flag (``make_lazy_plan``)


def _lane_rows(n_seeds: int, b: int, device) -> torch.Tensor:
    """The rows of a seed-parallel BFS call over [src; dst; neg_0 … neg_{S-1}]
    that train lane s reads, [src, dst, neg_s] → i64 [S, 3b]."""
    shared = torch.arange(2 * b, device=device).expand(n_seeds, -1)
    own = 2 * b + torch.arange(n_seeds * b, device=device).view(n_seeds, b)
    return torch.cat([shared, own], dim=1)


def _lane_blocks(n_seeds: int, device) -> torch.Tensor:
    """The query blocks each train lane reads: [src, dst, neg_s] → i64
    [S, 3]."""
    lanes = torch.arange(n_seeds, device=device)
    return torch.stack([torch.zeros_like(lanes), torch.ones_like(lanes),
                        2 + lanes], dim=1)


def check_finite(phase: str, batch: int, **parts) -> None:
    """``--debug_nans``: one host read of whether every tensor of ``parts``
    (name → tensor, or list of tensors) is finite; raises
    ``FloatingPointError`` naming the phase, the batch and the parts that
    are not."""
    names, flags = [], []
    for name, ts in parts.items():
        for x in ts if isinstance(ts, (list, tuple)) else [ts]:
            names.append(name)
            flags.append(torch.isfinite(x).all())
    ok = torch.stack(flags).tolist()
    bad = sorted({n for n, good in zip(names, ok) if not good})
    if bad:
        raise FloatingPointError(
            f"non-finite values in {phase} batch {batch}: {', '.join(bad)} "
            "(--debug_nans)")


def _roots(cfg: Config, s: Stream, offs, per_lane: bool):
    """A batch's query roots src‖dst‖neg ([S, 3b] raw ids per lane, which
    the forward moves into the lane's rows) and, for a tower that reads no
    T-PPR query, their times (else None)."""
    times3 = None if cfg.uses_tppr else torch.cat([s.t, s.t, s.t])
    if per_lane:
        n = offs.shape[0]
        return torch.cat([s.src.expand(n, -1), s.dst.expand(n, -1), s.neg.T],
                         dim=1), times3
    return torch.cat([s.src, s.dst, s.neg]), times3


def _bfs(cfg: Config, index: NeighborIndex, alpha_beta, s: Stream,
         blocks: Optional[torch.Tensor]) -> Tuple[TpprQueries, float]:
    """A batch's ``query`` part under the pruning strategy and its host
    seconds: one BFS over the roots [src; dst; neg] (per lane, where
    ``blocks`` is :func:`_lane_rows`, [src; dst; neg_0 … neg_{S-1}], lane
    s reading the shared src and dst roots and its own negatives)."""
    with part(QUERY):
        t0 = time.perf_counter()
        negs = [s.neg] if blocks is None else list(s.neg.T)
        q = pruned_queries(cfg, index, alpha_beta, [s.src, s.dst, *negs], s.t)
        if blocks is not None:
            q = TpprQueries(*(x[:, blocks].movedim(1, 0) for x in q))
        return q, time.perf_counter() - t0


def run_phase(bound: Bound, train: bool, optimizer, stream: Stream,
              queries: Union[torch.Tensor, NeighborIndex, None],
              n_valid: Sequence[int], *,
              nbr_index: Optional[NeighborIndex] = None,
              phase: str = "train",
              graphs: Optional[BatchGraphs] = None) -> Ran:
    """One pass over the batches of ``stream`` on the model state
    ``bound`` (``cfg``, ``params``, ``mem``, ``edge_feats``, the dropout
    ``generator``, the lane offsets ``offs``) with their T-PPR queries:
    ``queries`` holds the extraction rows [E, 3, F] (streaming), or is the
    adjacency index the batches' BFS calls search (pruning), or is None
    for a tower that reads no T-PPR query (``cfg.uses_tppr`` false).
    Those towers embed each root at its event time; the recursive ones
    search ``nbr_index``, the adjacency index of the phase's graph.
    ``n_valid`` holds each batch's count of valid events (known on the
    host): a batch with padding passes its mask to the memory protocol, a
    full one passes None. Train batches take an Adam step of
    ``optimizer``. Updates ``mem`` and the parameters in place.

    Seed-parallel, ``offs`` (i64 [S], s·N) selects the S-lane pass (module
    docstring): stacked ``params``, flat ``mem``, ``generator`` one per
    lane, train negatives [E, S] with rows [E, 2+S, F].

    Under a message-source flag the batch's src and dst embeddings feed
    its messages: in training those of the train forward, detached
    (dropout included), in eval those of the eval forward. Eval batches
    take the fused protocol under ``last`` and store then commit under
    ``mean``.

    Each batch is a ``zebra.batch`` span of its parts (``part``,
    ``utils/profiling.py``): the BFS (``query``, pruning), then
    :func:`_train_batch`'s parts, or in eval forward, protocol and
    metrics. Under ``cfg.debug_nans`` each batch ends with a host read of
    whether its loss, logits, updated parameters and written memory rows
    are finite (:func:`check_finite`, naming ``phase``); without it
    nothing is added.

    With ``graphs`` (``train/graphs.py``), each batch that
    :func:`~zebra_tpu_torch.train.graphs.replays` selects (a full
    streaming train batch on the card) replays the graphs captured from
    the parts; ``graphs`` counts those and the train batches that ran
    eagerly."""
    cfg, params, mem, edge_feats, generator, offs = bound
    b = cfg.bs
    per_lane = offs is not None and stream.neg.dim() == 2
    rows = queries if isinstance(queries, torch.Tensor) else None
    index = queries if isinstance(queries, NeighborIndex) else None
    alpha_beta = None if index is None else ensemble_tensors(
        cfg, index.arena.device)
    blocks = None
    if per_lane and queries is not None:
        n_l = offs.shape[0]
        blocks = (_lane_rows(n_l, b, offs.device) if index is not None
                  else _lane_blocks(n_l, offs.device))

    def query(s: Stream, x):
        # a batch's extraction rows → its queries (per lane, lane s reads
        # the blocks [src, dst, neg_s]); a BFS's, or None, as they are
        if not isinstance(x, torch.Tensor):
            return x
        return batch_queries(cfg, x if blocks is None
                             else x[:, blocks].transpose(0, 1), s.t)

    def forward(s: Stream, x) -> _Out:
        optimizer.zero_grad(set_to_none=True)
        return _train_forward(cfg, params, mem, edge_feats, s, query(s, x),
                              generator, offs, per_lane, nbr_index)

    def backward(out: _Out) -> None:
        # the lanes share no parameter: the sum's gradient is each lane's
        (out.loss if offs is None else out.loss.sum()).backward()

    parts = Parts(
        forward, backward,
        lambda s, out, valid: _train_protocol(cfg, params, mem, edge_feats,
                                              s, valid, offs, out.emb),
        _batch_metrics)
    dev = mem.memory.device
    out, bfs_s, overflow = [], 0.0, []
    for i, nv in enumerate(n_valid):
        with span(BATCH):
            s = Stream(*(x[i * b: (i + 1) * b] for x in stream))
            valid = None if nv == b else s.valid
            x = None if rows is None else rows[i * b: (i + 1) * b]
            if index is not None:
                x, secs = _bfs(cfg, index, alpha_beta, s, blocks)
                bfs_s += secs
            if train:
                p = parts
                if graphs is not None:
                    if replays(cfg, train, dev, queries, nv == b):
                        p = graphs.bind(bound, parts, s, x)
                    else:
                        graphs.eager += 1
                fwd, row = _train_batch(p, optimizer, s, x, valid)
                if fwd.plan is not None:
                    overflow.append(fwd.plan.overflow)
            else:
                with part(FORWARD), torch.no_grad():
                    fwd = _eval_forward(cfg, params, mem, edge_feats, s,
                                        query(s, x), offs, per_lane,
                                        nbr_index)
                with part(PROTOCOL):
                    src_emb, dst_emb = _message_embs(cfg, fwd.emb, b)
                    eval_protocol(cfg, params, mem, edge_feats, s.src, s.dst,
                                  s.t, s.eidx, valid, offs, src_emb, dst_emb)
                with part(profiling.METRICS):
                    row = _batch_metrics(s, fwd)
            if cfg.debug_nans:
                ids = lane_ids(torch.cat([s.src, s.dst]).to(torch.int64),
                               offs)
                check_finite(phase, i, loss=fwd.loss.detach(),
                             logits=[fwd.pos_logit.detach(),
                                     fwd.neg_logit.detach()],
                             params=(list(params.parameters()) if train
                                     else []),
                             memory=[mem.memory[ids], mem.messages[ids]])
            out.append(row)
    return Ran(torch.stack(out), bfs_s, overflow)


class _Out(NamedTuple):
    """A batch's forward: its lazy plan (None for the towers other than
    diffusion, and in eval), embeddings, link logits and loss (0 in
    eval)."""

    plan: Optional[LazyPlan]
    emb: torch.Tensor
    pos_logit: torch.Tensor
    neg_logit: torch.Tensor
    loss: torch.Tensor


def _train_batch(p: Parts, optimizer, s: Stream, x, valid):
    """A train batch's parts in order, each a ``part``: ``forward`` (from
    ``x``: the extraction rows, the BFS's queries or None), ``backward``,
    Adam's eager step, ``protocol`` (``valid`` the mask of a padded batch,
    else None) and ``metrics``. ``p`` holds the functions that run them
    eagerly, or their replays (``BatchGraphs.bind``). Returns the
    forward's outputs and the batch's metrics row."""
    with part(FORWARD):
        out = p.forward(s, x)
    with part(BACKWARD):
        p.backward(out)
    with part(ADAM):
        optimizer.step()
    with part(PROTOCOL):
        p.protocol(s, out, valid)
    with part(profiling.METRICS):
        return out, p.metrics(s, out)


def _link_loss(pos_logit, neg_logit, valid, count=None) -> torch.Tensor:
    """BCE(pos, 1) + BCE(neg, 0), each a masked mean over ``valid`` (over
    ``count`` events where given: a block's share of its batch's)."""
    bce = F.binary_cross_entropy_with_logits
    return (_masked_mean(bce(pos_logit, torch.ones_like(pos_logit),
                             reduction="none"), valid, count)
            + _masked_mean(bce(neg_logit, torch.zeros_like(neg_logit),
                               reduction="none"), valid, count))


def _train_forward(cfg: Config, params, mem: MemoryState, edge_feats,
                   s: Stream, q: Optional[TpprQueries], generator, offs,
                   per_lane: bool, nbr_index) -> _Out:
    """The train forward of a batch: the queries' roots, the lazy plan,
    the towers, the scores and the loss."""
    nodes3, times3 = _roots(cfg, s, offs, per_lane)
    plan = train_plan(cfg, q, nodes3, offs)
    emb = _forward(cfg, params, mem, edge_feats, nodes3, q, train=True,
                   generator=generator, offs=offs, times=times3,
                   nbr_index=nbr_index, plan=plan)
    pos_logit, neg_logit = _scores(cfg, params, emb, cfg.bs)
    return _Out(plan, emb, pos_logit, neg_logit,
                _link_loss(pos_logit, neg_logit, s.valid))


def _eval_forward(cfg: Config, params, mem: MemoryState, edge_feats,
                  s: Stream, q: Optional[TpprQueries], offs, per_lane: bool,
                  nbr_index) -> _Out:
    """The eval forward of a batch (raw memory, no dropout)."""
    nodes3, times3 = _roots(cfg, s, offs, per_lane)
    emb = _forward(cfg, params, mem, edge_feats, nodes3, q, offs=offs,
                   times=times3, nbr_index=nbr_index)
    pos_logit, neg_logit = _scores(cfg, params, emb, cfg.bs)
    return _Out(None, emb, pos_logit, neg_logit,
                torch.zeros(pos_logit.shape[:-1], device=emb.device))


def _message_embs(cfg: Config, emb: torch.Tensor, b: int):
    """Under a message-source flag the batch's src and dst embeddings (the
    first two blocks of ``b`` rows of ``emb``), detached; else None."""
    if not cfg.need_emb:
        return None, None
    emb = emb.detach()
    return emb[..., :b, :], emb[..., b: 2 * b, :]


def _train_protocol(cfg: Config, params, mem: MemoryState, edge_feats,
                    s: Stream, valid, offs, emb: torch.Tensor) -> None:
    """The train memory protocol: commit earlier batches' messages with the
    updated parameters, then store this batch's (one-batch staleness);
    under a message-source flag with the forward's detached src and dst
    embeddings."""
    src_emb, dst_emb = _message_embs(cfg, emb, cfg.bs)
    _commit_pending(cfg, params, mem, torch.cat([s.src, s.dst]),
                    None if valid is None else torch.cat([valid, valid]),
                    offs)
    _store_messages(cfg, params, mem, edge_feats, s.src, s.dst, s.t, s.eidx,
                    valid, offs, src_emb, dst_emb)


@torch.no_grad()
def _metrics_row(loss, pos_p, neg_p, valid) -> torch.Tensor:
    """A batch's row of :data:`METRICS` from its link probabilities
    ([S, 4] per lane)."""
    return torch.stack([loss, masked_ap(pos_p, neg_p, valid),
                        masked_auc(pos_p, neg_p, valid),
                        masked_rank_acc(pos_p, neg_p, valid)], dim=-1)


@torch.no_grad()
def _batch_metrics(s: Stream, out: _Out) -> torch.Tensor:
    return _metrics_row(out.loss, torch.sigmoid(out.pos_logit),
                        torch.sigmoid(out.neg_logit), s.valid)


# ------------------------------------------------------------ row-sharded

class RowPlan(NamedTuple):
    """A superchunk's plan of the row-sharded batches, made on the host
    from the event columns (:func:`plan_rows`) and uploaded once. The
    block of rank j in a batch is its events [j·b', (j+1)·b'), b' = b/D;
    its query rows are its src, dst and neg ids, 3b' of them."""

    uniq: torch.Tensor        # i64 [n_batches, D, 3b'] each rank's block's
                              # distinct node ids, padded with 0
    inv: torch.Tensor         # i64 [n_batches, 3b'] this rank's query rows
                              # → their place among its distinct ids
    send: torch.Tensor        # i64 [n_batches, 2b'] the block positions
                              # (src then dst) of the rows whose write this
                              # rank wins (padded with 0)
    take: torch.Tensor        # i64 [m] the entries of every rank's sent
                              # rows (D·2b' per batch) that this rank owns
    rows: torch.Tensor        # i64 [m] their local row ids
    bounds: Tuple[int, ...]   # batch i: take/rows[bounds[i]:bounds[i + 1]]
    acc: torch.Tensor         # i64 [a] the batch positions (cat([src, dst])
                              # order) of the valid messages whose sender
                              # this rank owns, ascending
    acc_rows: torch.Tensor    # i64 [a] their senders' local row ids
    acc_bounds: Tuple[int, ...]  # batch i: acc[acc_bounds[i]:…[i + 1]]


def plan_rows(src, dst, neg, valid, b: int, world: int, rank: int,
              rows_per_rank: int, device) -> RowPlan:
    """The :class:`RowPlan` of a superchunk's host columns (whole batches
    of ``b`` events). A batch writes the rows of its valid senders (src
    and dst of its valid events), each from the last valid position that
    names it (``cat([src, dst])`` order: the last-wins message and, since
    every sender is a committed positive, the row's every column); the
    rank whose block holds that position sends the row. Under ``mean``
    every valid message adds into its sender's row at the owner, in batch
    order (``acc``)."""
    bl = b // world
    n_b = len(src) // b
    uniq = np.zeros((n_b, world, 3 * bl), np.int64)
    inv = np.zeros((n_b, 3 * bl), np.int64)
    send = np.zeros((n_b, 2 * bl), np.int64)
    take, rows, bounds = [], [], [0]
    acc, acc_rows, acc_bounds = [], [], [0]
    for i in range(n_b):
        sl = slice(i * b, (i + 1) * b)
        s_, d_, n_ = (np.asarray(c[sl], np.int64) for c in (src, dst, neg))
        places = []
        for j in range(world):
            blk = slice(j * bl, (j + 1) * bl)
            u, iv = np.unique(np.concatenate([s_[blk], d_[blk], n_[blk]]),
                              return_inverse=True)
            uniq[i, j, :len(u)] = u
            places.append(iv)
        inv[i] = places[rank]
        snd = np.concatenate([s_, d_])
        valid2 = np.tile(np.asarray(valid[sl], bool), 2)
        last_first = np.flatnonzero(valid2)[::-1]
        _, first = np.unique(snd[last_first], return_index=True)
        win = np.sort(last_first[first])
        event, part = win % b, win // b
        sender = event // bl
        at = part * bl + event - sender * bl      # place in the block's rows
        slot = np.zeros_like(win)
        for j in range(world):
            mine = sender == j
            slot[mine] = np.arange(mine.sum())
            if j == rank:
                send[i, : mine.sum()] = at[mine]
        gid = snd[win]
        own = gid // rows_per_rank == rank
        take.append(sender[own] * 2 * bl + slot[own])
        rows.append(gid[own] - rank * rows_per_rank)
        bounds.append(bounds[-1] + int(own.sum()))
        mine = np.flatnonzero(valid2 & (snd // rows_per_rank == rank))
        acc.append(mine)
        acc_rows.append(snd[mine] - rank * rows_per_rank)
        acc_bounds.append(acc_bounds[-1] + len(mine))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
        device)
    cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0)
    return RowPlan(as_t(uniq), as_t(inv), as_t(send), as_t(cat(take)),
                   as_t(cat(rows)), tuple(bounds), as_t(cat(acc)),
                   as_t(cat(acc_rows)), tuple(acc_bounds))


def split_blocks(q: TpprQueries, world: int) -> TpprQueries:
    """A batch's queries [M, 3b, k] over the roots src‖dst‖neg → every
    rank's block's, fields [D, M, 3b', k] (rank j's block laid out as
    :func:`batch_queries` lays out a batch)."""
    m, n3, k = q.nbr.shape
    bl = n3 // (3 * world)
    return TpprQueries(*(x.reshape(m, 3, world, bl, k).permute(2, 0, 1, 3, 4)
                         .reshape(world, m, 3 * bl, k) for x in q))


def distinct_blocks(ids: torch.Tensor, n_nodes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row of ``ids`` [D, T] (rank j's node ids in row j) → its
    distinct ids ascending, [D, L] padded with 0 to the largest row's count
    L (one read back), and each id's place in its row, [D, T]."""
    d = ids.shape[0]
    lane = torch.arange(d, device=ids.device)
    key = ids.to(torch.int64) + n_nodes * lane[:, None]
    u, inv = torch.unique(key, return_inverse=True)
    blk = torch.div(u, n_nodes, rounding_mode="floor")
    counts = torch.bincount(blk, minlength=d)
    place = torch.arange(u.numel(), device=ids.device) - (
        torch.cumsum(counts, 0) - counts)[blk]
    out = torch.zeros((d, int(counts.max())), dtype=torch.int64,
                      device=ids.device)
    out[blk, place] = u - n_nodes * blk
    return out, place[inv]


def block_tree(tree: Sequence[Hop], world: int, n_nodes: int,
               rank: int) -> Tuple[torch.Tensor, List[Hop], int]:
    """A batch's hop tree over the roots src‖dst‖neg (:func:`hop_tree`) →
    (every rank's block's distinct ids [D, L], this rank's block's tree
    with its node ids as places among its distinct ids, the count of ids
    the blocks name with duplicates)."""
    def part(x, width):
        # [3b·w] root-major → [D, 3b'·w]: block j's roots and their subtrees
        return x.reshape(3, world, -1, width).transpose(0, 1).reshape(
            world, -1)
    levels = [part(h.nodes, 1) for h in tree]
    sizes = [x.shape[1] for x in levels]
    ids = torch.cat(levels, dim=1)
    uniq, inv = distinct_blocks(ids, n_nodes)
    local = inv[rank].split(sizes)
    hops = [Hop(local[0], part(tree[0].times, 1)[rank])]
    for h, nodes in zip(tree[1:], local[1:]):
        n = h.eidx.shape[-1]
        hops.append(Hop(nodes, part(h.times, 1)[rank],
                        part(h.eidx, n)[rank].view(-1, n),
                        part(h.valid, n)[rank].view(-1, n)))
    return uniq, hops, ids.numel()


def _all_reduce_grads(params, exchange) -> None:
    """Sum every gradient over the ranks (one flat buffer, one
    collective); every rank gets the same bits."""
    ps = [p for p in params.parameters() if p.grad is not None]
    flat = exchange.all_reduce_(
        torch.cat([p.grad.reshape(-1) for p in ps]), "grad")
    for p, g in zip(ps, flat.split([p.numel() for p in ps])):
        p.grad.copy_(g.view_as(p.grad))


class _Block(NamedTuple):
    """One rank's block of a row-sharded batch, fetched: its table of rows
    and how its inputs name them."""

    view: MemoryState             # the fetched rows
    nodes: torch.Tensor           # i64 [3b'] the query rows' local rows
    q: Optional[TpprQueries]      # diffusion: the block's queries over the
                                  # table ([M, 3b', k])
    every: Optional[TpprQueries]  # diffusion: the whole batch's (global ids)
    block_nbr: Optional[torch.Tensor]  # diffusion: the block's global ids
    tree: Optional[List[Hop]]     # recursive towers: the block's hop tree
                                  # over the table


def _fetch_block(cfg: Config, i: int, s: Stream, plan: RowPlan, exchange,
                 tables, qs: Optional[TpprQueries], nbr_index) -> _Block:
    """The rows one block reads, fetched (every rank knows every block's
    ids): the diffusion tower's distinct query nodes and the T-PPR
    neighbors of ``qs``, the whole batch's queries; the recursive towers'
    distinct ids of the whole batch's hop tree, per block; the memory-only
    towers' distinct query nodes."""
    b, world, rank = cfg.bs, exchange.mesh.size, exchange.mesh.rank
    bl, m, k = b // world, cfg.n_tppr, cfg.topk
    if not cfg.uses_tppr:
        if cfg.embedding_module not in RECURSIVE:
            view = MemoryState(*exchange.fetch(tables, plan.uniq[i],
                                               "tower_fetch"))
            return _Block(view, plan.inv[i], None, None, None, None)
        ids, tree, named = block_tree(
            hop_tree(cfg, nbr_index, torch.cat([s.src, s.dst, s.neg]),
                     torch.cat([s.t, s.t, s.t])),
            world, cfg.n_nodes, rank)
        view = MemoryState(*exchange.fetch(tables, ids, "tower_fetch",
                                           named))
        return _Block(view, tree[0].nodes, None, None, None, tree)
    qs = split_blocks(qs, world)
    q = TpprQueries(*(x[rank] for x in qs))
    ids = torch.cat([plan.uniq[i], qs.nbr.reshape(world, -1).to(torch.int64)],
                    dim=1)
    view = MemoryState(*exchange.fetch(tables, ids, "tower_fetch"))
    # the neighbors' rows in the fetched table, after the distinct nodes
    local = 3 * bl + torch.arange(m * 3 * bl * k, device=ids.device).view(
        m, 3 * bl, k)
    every = q._replace(nbr=qs.nbr.movedim(0, 1).reshape(m, -1, k))
    return _Block(view, plan.inv[i], q._replace(nbr=local), every, q.nbr,
                  None)


def run_phase_rows(bound: Bound, train: bool, optimizer, stream: Stream,
                   queries, n_valid: Sequence[int], plan: RowPlan, exchange,
                   *, nbr_index: Optional[NeighborIndex] = None,
                   phase: str = "train") -> Ran:
    """One pass of a row-sharded rank over the batches of ``stream`` (the
    whole batches, the same on every rank) and the chunk's
    :class:`RowPlan`, on the model state ``bound`` (one seed, ``mem``
    this rank's rows, which change in place where this rank owns a row a
    batch writes). ``queries`` and ``nbr_index`` are what
    :func:`run_phase` takes: the chunk's extraction rows [E, 3, F] (every
    rank holds all of them), the adjacency index of the batches' BFS
    calls (pruning), or None for the other towers, the recursive ones
    searching ``nbr_index``.

    Each batch is a ``zebra.batch`` span of its parts: the BFS over the
    whole batch's roots (``query``, pruning); ``fetch``, one
    ``exchange.fetch`` of the rows of every rank's block
    (:func:`_fetch_block`) into a table of its own; ``forward``, the
    towers on this rank's block over that table, with the lazy-update
    plan made from the global ids and the dropout masks of the whole
    batch (:class:`BlockMasks`), a query row updating lazily where its
    node is among the whole batch's selected neighbors
    (:func:`block_lazy_plan`, whose overflow flag is the whole batch's),
    and in training the loss as this block's share of the batch's masked
    means (over the batch's valid count); in training ``backward``,
    ``allreduce`` (the gradients summed over the ranks) and ``adam``;
    ``protocol``, the block's memory protocol on the table, with the
    block's embeddings in its messages under a message-source flag; and
    ``send``, one ``exchange.send`` of the rows this rank's block wins.
    Under ``mean`` the messages cross whole: every block's stored message
    rows are gathered, and each owner adds the ones of its senders in
    batch order, as one process does; in eval the owner then commits its
    senders' rows.

    The metrics of the returned :class:`Ran` are this block's (pos, neg)
    probabilities [n_batches, 2, b'] and its share of each batch's loss
    [n_batches] (0 in eval); the caller gathers them at the phase's end
    (:func:`rows_metrics`)."""
    cfg, params, mem, edge_feats, generator, _ = bound
    b, world, rank = cfg.bs, exchange.mesh.size, exchange.mesh.rank
    bl = b // world
    bcfg = cfg.single_seed().replace(bs=bl)   # the config of one block
    dev = mem.memory.device
    tables = tuple(mem)
    mean = cfg.aggregator == "mean"
    index = queries if isinstance(queries, NeighborIndex) else None
    alpha_beta = None if index is None else ensemble_tensors(cfg, dev)
    mine = slice(rank * bl, (rank + 1) * bl)
    ar = torch.arange(bl, device=dev)
    # this block's rows among the batch's 3b query rows (its dropout masks)
    block_rows = torch.cat([rank * bl + ar, b + rank * bl + ar,
                            2 * b + rank * bl + ar])
    probs, losses, bfs_s, overflow = [], [], 0.0, []
    for i, nv in enumerate(n_valid):
        with span(BATCH):
            s = Stream(*(x[i * b: (i + 1) * b] for x in stream))
            blk = Stream(*(x[mine] for x in s))
            valid = None if nv == b else blk.valid
            qs = None
            if index is not None:
                qs, secs = _bfs(cfg, index, alpha_beta, s, None)
                bfs_s += secs
            with part(FETCH):
                if isinstance(queries, torch.Tensor):
                    qs = batch_queries(cfg, queries[i * b: (i + 1) * b], s.t)
                bb = _fetch_block(cfg, i, s, plan, exchange, tables, qs,
                                  nbr_index)
            view, nodes = bb.view, bb.nodes
            src_l, dst_l = nodes[:bl], nodes[bl: 2 * bl]

            def embed(lazy=None):
                if bb.tree is not None:
                    return tree_embed(bcfg, params, view, edge_feats,
                                      bb.tree, train)
                return _forward(
                    bcfg, params, view, edge_feats, nodes, bb.q, train=train,
                    plan=lazy, times=torch.cat([blk.t, blk.t, blk.t]),
                    generator=(BlockMasks(generator, block_rows, 3 * b)
                               if train else None))

            def store(src_emb, dst_emb):
                # mean: this block's message rows, which _add_messages
                # gathers; last: the store (in eval, store-commit) on the
                # table
                if mean:
                    return stored_messages(bcfg, view, edge_feats, src_l,
                                           dst_l, blk.t, blk.eidx, None,
                                           None, src_emb, dst_emb)[-1]
                (_store_messages if train else eval_protocol)(
                    bcfg, params, view, edge_feats, src_l, dst_l, blk.t,
                    blk.eidx, valid, None, src_emb, dst_emb)
                return None

            if train:
                with part(FORWARD):
                    lazy = None
                    if cfg.uses_tppr:
                        lazy = block_lazy_plan(
                            cfg, bb.every,
                            torch.cat([blk.src, blk.dst, blk.neg]),
                            bb.block_nbr, bb.q.nbr)
                        overflow.append(lazy.overflow)
                    optimizer.zero_grad(set_to_none=True)
                    emb = embed(lazy)
                    pos_logit, neg_logit = _scores(bcfg, params, emb, bl)
                    loss = _link_loss(pos_logit, neg_logit, blk.valid,
                                      max(int(nv), 1))
                with part(BACKWARD):
                    loss.backward()
                with part(ALLREDUCE):
                    _all_reduce_grads(params, exchange)
                with part(ADAM):
                    optimizer.step()
                with part(PROTOCOL):
                    _commit_pending(bcfg, params, view,
                                    torch.cat([src_l, dst_l]),
                                    None if valid is None
                                    else torch.cat([valid, valid]))
                    msg = store(*_message_embs(cfg, emb, bl))
                    loss = loss.detach()
            else:
                with torch.no_grad():
                    with part(FORWARD):
                        emb = embed()
                        pos_logit, neg_logit = _scores(bcfg, params, emb, bl)
                    with part(PROTOCOL):
                        msg = store(*_message_embs(cfg, emb, bl))
                loss = torch.zeros((), device=dev)
            with part(SEND):
                if train or not mean:
                    # the rows this block wins, every column, to their
                    # owners
                    lo, hi = plan.bounds[i], plan.bounds[i + 1]
                    won = nodes.index_select(0, plan.send[i])
                    exchange.send(tables,
                                  [x.index_select(0, won) for x in view],
                                  plan.take[lo:hi], plan.rows[lo:hi],
                                  "tower_send")
                lo, hi = plan.acc_bounds[i], plan.acc_bounds[i + 1]
                owned = plan.acc_rows[lo:hi]
                if mean:
                    _add_messages(exchange, mem, msg, plan.acc[lo:hi], owned,
                                  s.t, bl)
                    if not train:
                        # the eval commit reads the sums every block adds
                        # to: the owner commits its senders, over the
                        # batch's 2b positions as one process does (other
                        # ranks' rows masked out)
                        snd = (torch.cat([s.src, s.dst]).to(torch.int64)
                               - exchange.lo)
                        mask = ((snd >= 0) & (snd < exchange.rows)
                                & torch.cat([s.valid, s.valid]))
                        _commit_pending(bcfg, params, mem,
                                        torch.where(mask, snd, 0), mask)
            if cfg.debug_nans:
                rows = torch.cat([src_l, dst_l])
                written = ([mem.memory[owned], mem.messages[owned]] if mean
                           else [view.memory[rows], view.messages[rows]])
                check_finite(phase, i, loss=loss,
                             logits=[pos_logit.detach(), neg_logit.detach()],
                             params=list(params.parameters()) if train
                             else [],
                             memory=written)
            with torch.no_grad():
                probs.append(torch.stack([torch.sigmoid(pos_logit),
                                          torch.sigmoid(neg_logit)]))
            losses.append(loss)
    return Ran((torch.stack(probs), torch.stack(losses)), bfs_s, overflow)


@torch.no_grad()
def _add_messages(exchange, mem: MemoryState, msg: torch.Tensor,
                  acc: torch.Tensor, rows: torch.Tensor, t: torch.Tensor,
                  bl: int) -> None:
    """``mean``'s store across the blocks: every rank's stored message rows
    [2b', W] (its block's src then dst positions) gathered, then the ones
    at the batch positions ``acc`` (ascending, ``cat([src, dst])`` order)
    added into this rank's rows ``rows``, in that order
    (:func:`accumulate_messages`); ``t`` [b] the batch's event times."""
    got, = exchange.gather_rows([msg], "msg_send")     # [D·2b', W]
    b = t.shape[0]
    part, event = torch.div(acc, b, rounding_mode="floor"), acc % b
    j = torch.div(event, bl, rounding_mode="floor")
    at = j * 2 * bl + part * bl + event - j * bl      # place in the gather
    accumulate_messages(mem, rows, got.index_select(0, at),
                        torch.cat([t, t]).index_select(0, acc))


def rows_metrics(exchange, probs: torch.Tensor, losses: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """A row-sharded phase's end: every rank's block probabilities
    [n_batches, 2, b'] and loss shares [n_batches] gathered once, then the
    per-batch metrics [n_batches, 4] (:data:`METRICS`) of the whole batches
    as one process computes them, ``valid`` [n_batches·b] the stream's
    mask."""
    world = exchange.mesh.size
    g = exchange.all_gather(probs, "scores")          # [D, nb, 2, b']
    n_b = probs.shape[0]
    probs = g.permute(1, 2, 0, 3).reshape(n_b, 2, -1)
    loss = exchange.all_gather(losses, "scores").sum(0)
    valid = valid.view(n_b, -1)
    return torch.stack([_metrics_row(loss[i], probs[i, 0], probs[i, 1],
                                     valid[i]) for i in range(n_b)])
