"""Online serving: score candidate links against live state and ingest
observed interactions (counterpart of ``zebra_tpu/serve.py``).

Example::

    predictor = LinkPredictor(cfg, params, mem, index_state, edge_feats)
    # or LinkPredictor.from_trainer(trainer) after training, or
    # LinkPredictor.from_checkpoint(state_file, edge_feats=...) to deploy
    probs = predictor.score(src, dst, t)        # link probabilities [B]
    predictor.observe(src, dst, t, eidx)        # stream new interactions

The predictor runs on CUDA unless ``device="cpu"`` is passed. ``observe``
streams the events through the T-PPR index (``fill_scan``: one
``santa_scan`` kernel launch per call on the card), then applies the
eval-mode memory protocol, on the card replayed from a CUDA graph of the
call's length (``train/graphs.py:ProtocolGraphs``); ``score`` is
read-only. Both refuse node ids outside [0, N) on the host, before
anything reaches the device. Under a message-source flag the messages
take the events' embeddings: ``observe`` then runs an eval forward at
[src; dst; dst] first, whose diffusion queries are the pre-edge rows the
scan extracts (``streaming_scan``, still one ``santa_scan`` launch) or,
under pruning, one BFS.

Under the pruning strategy the predictor holds no T-PPR state but an
adjacency index (``nbr_index``) and the event stream it was built from
(``events``); ``score`` queries it by a bounded BFS, and ``observe`` folds
the new events into it (every ``rebuild_every`` events, or at
``flush_index()``) before the memory protocol: on the index's device by
appending the new slots where they keep the build's order (events
observed in time order), else by a rebuild on the host. The towers other
than diffusion hold no T-PPR state under either strategy; the recursive
ones search the adjacency index, which ``observe`` folds the same way. An
observed edge id past the feature table reads the table's last row there,
as JAX's clamped gather does.

A state file trained with interleaved node ids (``Config.
interleave_shards``: a row-sharded run with ``--interleave_node_ids``)
holds its rows in the permuted id space: the predictor rebuilds the
permutation from the shard count and maps every external node id of
``score``, ``observe`` and ``events`` through it (:meth:`LinkPredictor.
_map_ids`), after the range check; ``from_trainer`` passes the Trainer's
events, already internal (``internal_ids``). A row-sharded Trainer's
file serves on one device like any other.

A seed-parallel training run (``--parallel_runs``) serves one seed,
``LinkPredictor.from_checkpoint(path, run_index=s)``, or all of them as a
deep ensemble, :class:`EnsemblePredictor` (``from_checkpoint(path,
ensemble=True)`` or ``EnsemblePredictor.from_trainer``): the mean member
probability from one batched pass.

Under a ``torch.profiler`` each call runs in a span
(``utils/profiling.py``): ``zebra.observe`` holds ``zebra.request`` (the id
check, the id map and the uploads; under pruning and the recursive towers
the adjacency fold too), ``zebra.scan`` (with its ``zebra.read_ids``) and
``zebra.protocol`` (a replay, or a ``zebra.capture``); ``zebra.score``
holds ``zebra.request``, ``zebra.query``, ``zebra.forward`` and
``zebra.readback``."""

from __future__ import annotations

import copy
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.index.neighbor_finder import (
    NeighborIndex,
    append_events,
    build_neighbor_index,
)
from zebra_tpu_torch.index.queries import (
    ensemble_tensors,
    flat_blocks,
    pruned_queries,
)
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    TpprQueries,
    TpprState,
    check_id_width,
    fill_scan,
    read_topk,
    streaming_scan,
)
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import affinity_score, params_from_state_dict
from zebra_tpu_torch.parallel.sharding import interleave_permutation
from zebra_tpu_torch.train.checkpoint import load_checkpoint
from zebra_tpu_torch.train.graphs import Bound, ProtocolGraphs
from zebra_tpu_torch.train.step import _forward, eval_protocol
from zebra_tpu_torch.utils.profiling import (
    FOLD,
    FORWARD,
    OBSERVE,
    PROTOCOL,
    QUERY,
    READBACK,
    REQUEST,
    SCAN,
    SCORE,
    span,
)

logger = logging.getLogger("zebra_tpu_torch")


def check_node_ids(n_nodes: int, *cols) -> None:
    """Raise ``ValueError`` unless every id in the host columns ``cols``
    lies in [0, ``n_nodes``): on the card an id outside would trip a
    device-side assert in a gather, which leaves the process's CUDA context
    unusable."""
    ids = [np.asarray(c) for c in cols if np.size(c)]
    if not ids:
        return
    lo = min(int(c.min()) for c in ids)
    hi = max(int(c.max()) for c in ids)
    if lo < 0 or hi >= n_nodes:
        raise ValueError(f"node ids must lie in [0, {n_nodes}), got "
                         f"[{lo}, {hi}]")


def events_to_internal(cfg: Config, events):
    """External-id event columns → the internal (interleave-permuted) id
    space (``zebra_tpu/serve.py:_events_to_internal``); themselves where
    the config trained without the interleave."""
    if events is None or int(cfg.interleave_shards or 0) <= 1:
        return events
    perm = interleave_permutation(cfg.n_nodes, cfg.interleave_shards)
    return (perm[np.asarray(events[0], np.int64)],
            perm[np.asarray(events[1], np.int64)]) + tuple(events[2:])


class LinkPredictor:
    """Stateful scorer over a (params, memory, index) snapshot.

    The predictor keeps its own copies of the state on ``device`` and
    updates memory and index in place as it observes events."""

    _stacked = False  # EnsemblePredictor: params and memory carry [S, ...]

    def __init__(self, cfg: Config, params, mem: MemoryState,
                 index_state: Optional[TpprState], edge_feats,
                 nbr_index: Optional[NeighborIndex] = None,
                 events: Optional[Tuple[np.ndarray, ...]] = None,
                 rebuild_every: int = 1, device=None,
                 internal_ids: bool = False):
        """``index_state`` is the streaming diffusion tower's T-PPR state
        (None otherwise). ``nbr_index`` is the adjacency index of the
        pruning strategy and the recursive towers, and ``events`` the
        (sources, destinations, timestamps, edge_idxs) stream it was built
        from: with them ``observe()`` folds new interactions into the
        index once ``rebuild_every`` events are pending (1: at every call;
        ``flush_index()`` forces a fold). Without ``events`` the index
        stays as given, and observe() warns once. ``events`` carry external ids
        (mapped through the interleave, where the config used one) unless
        ``internal_ids``."""
        self.device = resolve_device(device)
        if index_state is not None:
            # the packed T-PPR rows hold ids as f32 values
            check_id_width(cfg.n_nodes, cfg.n_edges)
        self.cfg = cfg
        dev = self.device
        self.params = copy.deepcopy(params).to(dev).requires_grad_(False)
        self.mem = MemoryState(*(x.to(dev, copy=True) for x in mem))
        self.index_state = (None if index_state is None else
                            TpprState(index_state.data.to(dev, copy=True)))
        self.edge_feats = torch.as_tensor(edge_feats).to(
            dev, torch.float32, copy=True)
        self._tppr = TpprParams.create(cfg.alpha_list, cfg.beta_list, cfg.topk)
        self._offs = None   # the members' row offsets (EnsemblePredictor)
        # the index is never changed in place (a fold builds a new one), so
        # a Trainer's may be shared
        self.nbr_index = None if nbr_index is None else nbr_index.to(dev)
        self._alpha_beta = ensemble_tensors(cfg, dev)
        # rows live in the interleave's id space where training used it:
        # external ids map through it at this boundary
        self._id_perm = None
        if int(cfg.interleave_shards or 0) > 1:
            self._id_perm = interleave_permutation(cfg.n_nodes,
                                                   cfg.interleave_shards)
        if not internal_ids:
            events = events_to_internal(cfg, events)
        self._events = (None if events is None else
                        tuple(np.array(c) for c in events[:4]))
        # capacity buffers of the folded stream: while ``_events`` is the
        # tuple ``_events_out`` that the last fold handed out, it is a view
        # of their filled rows
        self._events_buf: Tuple[np.ndarray, ...] = ()
        self._events_out: Optional[Tuple[np.ndarray, ...]] = None
        self._pending: list = []
        self._pending_n = 0
        self._fold_appends = self._fold_rebuilds = 0
        self.rebuild_every = max(1, int(rebuild_every))
        self._warned_static = False
        self._protocol = ProtocolGraphs()

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[Config] = None,
                        edge_feats=None, events=None, rebuild_every: int = 1,
                        run_index: int = 0, ensemble: bool = False,
                        device=None) -> "LinkPredictor":
        """A predictor over a ``Trainer.save_state`` file, with no live
        Trainer (the deployment path). ``cfg`` defaults to the one stored in
        the file; ``edge_feats`` to zeros, which a model trained with real
        edge features refuses. ``events``, the training stream's
        (sources, destinations, timestamps, edge_idxs), is required under
        the pruning strategy and for the recursive towers: the adjacency
        index is built from it (the state file holds none), and
        ``rebuild_every`` is the predictor's.

        From a seed-parallel file (``--parallel_runs``: params and memory
        carry a leading seed axis, the index is shared) ``run_index``
        serves one seed, and ``ensemble=True`` serves all of them as an
        :class:`EnsemblePredictor`."""
        dev = resolve_device(device)
        ckpt = load_checkpoint(path)
        cfg = cfg if cfg is not None else Config.from_dict(ckpt["cfg"])
        params, mem = ckpt["params"], ckpt["mem"]
        if ensemble:
            if cfg.parallel_runs <= 1:
                raise ValueError(
                    "ensemble=True needs a seed-parallel checkpoint "
                    "(--parallel_runs > 1); this one is single-seed")
            if run_index:
                raise ValueError("pass run_index OR ensemble=True, not both")
            cls = EnsemblePredictor
            cfg = cfg.single_seed()
        elif cfg.parallel_runs > 1:
            if not 0 <= run_index < cfg.parallel_runs:
                raise ValueError(
                    f"run_index {run_index} out of range for a "
                    f"{cfg.parallel_runs}-seed checkpoint")
            params = {k: v[run_index] for k, v in params.items()}
            mem = {k: v[run_index] for k, v in mem.items()}
            cfg = cfg.single_seed()
        elif run_index:
            raise ValueError(
                f"run_index {run_index} given, but this checkpoint is "
                "single-seed (no seed axis to select from)")
        if edge_feats is None:
            real = cfg.real_edge_feats
            if real is None:  # a config that did not record it
                real = cfg.edge_dim > 1 and not cfg.ignore_edge_feats
            if real:
                # scores from zeroed features would be finite but wrong
                raise ValueError(
                    f"this checkpoint was trained with {cfg.edge_dim}-dim "
                    "edge features; pass edge_feats= (the training "
                    "ml_{d}.npy matrix)")
            edge_feats = np.zeros((cfg.n_edges, cfg.edge_dim), np.float32)
        nbr_index = None
        if cfg.needs_adjacency:
            if events is None:
                raise ValueError(
                    f"tppr_strategy={cfg.tppr_strategy!r} / embedding_module="
                    f"{cfg.embedding_module!r} query an adjacency index; "
                    "pass events=(sources, destinations, timestamps, "
                    "edge_idxs) of the training stream")
            nbr_index = build_neighbor_index(
                *events_to_internal(cfg, events)[:4], cfg.n_nodes, dev)
        index_state = ckpt["index_state"]
        return cls(cfg, params_from_state_dict(params), MemoryState(**mem),
                   None if index_state is None else TpprState(index_state),
                   edge_feats, nbr_index, events, rebuild_every, device=dev)

    @classmethod
    def from_trainer(cls, trainer, rebuild_every: int = 1) -> "LinkPredictor":
        """A predictor over a port Trainer's current params, memory, index
        and edge features, on the Trainer's device (copies: the Trainer
        trains on undisturbed); under the pruning strategy and for the
        recursive towers the full graph's adjacency index, with the full
        split's events as the base stream of the folds. A seed-parallel
        Trainer serves through ``EnsemblePredictor.from_trainer``. A rank
        of a row-sharded Trainer gathers every rank's rows first (a
        collective: every rank calls it) and serves them whole on its
        device; the Trainer's ids are internal already."""
        n_seeds = trainer.cfg.n_seeds
        if n_seeds > 1 and not cls._stacked:
            raise ValueError(
                "this Trainer is seed-parallel: serve all seeds with "
                "EnsemblePredictor.from_trainer, or one seed via "
                "from_checkpoint(run_index=...)")
        if n_seeds == 1 and cls._stacked:
            raise ValueError("EnsemblePredictor needs a seed-parallel Trainer "
                             "(--parallel_runs > 1)")
        if trainer.mesh.size > 1 and n_seeds > 1:
            raise ValueError(
                "this Trainer is one rank of a seed-sharded run and holds "
                "some of the seeds: serve its state file with "
                "from_checkpoint (ensemble=True or run_index=...)")
        cfg = trainer.cfg.single_seed()
        fu = trainer.splits.full
        if n_seeds > 1:
            mem, index_state = (MemoryState(**trainer._memory_tables()),
                                trainer.index_state)
        else:
            mem, index_state = trainer.gathered_state()
        return cls(cfg, trainer.params, mem, index_state, trainer.edge_feats,
                   trainer.full_nbr_index,
                   (fu.sources, fu.destinations, fu.timestamps, fu.edge_idxs),
                   rebuild_every, device=trainer.device, internal_ids=True)

    # ------------------------------------------------------------ adjacency

    def _append_events(self, src, dst, t, eidx) -> None:
        """Queue observed interactions for the adjacency index, and fold
        them once ``rebuild_every`` are pending (a no-op for the streaming
        strategy, whose index is the updated T-PPR state)."""
        if self.nbr_index is None:
            return
        if self._events is None:
            if not self._warned_static:
                logger.warning(
                    "LinkPredictor has no base event stream: observe()d "
                    "interactions update memory%s but NOT the adjacency "
                    "index — pruning/recursive queries will not see them. "
                    "Pass events= (or use from_trainer) to enable index "
                    "folding.",
                    "/T-PPR state" if self.index_state is not None else "")
                self._warned_static = True
            return
        self._pending.append((np.asarray(src, np.int64),
                              np.asarray(dst, np.int64),
                              np.asarray(t, np.float64),
                              np.asarray(eidx, np.int64)))
        self._pending_n += len(self._pending[-1][0])
        if self._pending_n >= self.rebuild_every:
            self.flush_index()

    @property
    def fold_appends(self) -> int:
        """Folds made by appending the new slots on the device so far."""
        return self._fold_appends

    @property
    def fold_rebuilds(self) -> int:
        """Folds made by rebuilding the whole index on the host so far."""
        return self._fold_rebuilds

    @property
    def protocol_captures(self) -> int:
        """Observes whose eval protocol was captured in a CUDA graph (and
        ran eagerly once, on the capture stream) so far."""
        return self._protocol.captures

    @property
    def protocol_replays(self) -> int:
        """Observes whose eval protocol replayed its graph so far."""
        return self._protocol.replays

    @property
    def protocol_eager(self) -> int:
        """Observes whose eval protocol ran eagerly so far."""
        return self._protocol.eager

    def flush_index(self) -> None:
        """Fold every pending observed interaction into a new adjacency
        index (the old one is left as it is), one ``zebra.fold`` span: the
        pending slots appended on the index's device
        (``neighbor_finder.append_events``), or, where that would not keep
        the build's order, a rebuild on the host from the base stream and
        the pending events, then one upload."""
        if not self._pending:
            return
        with span(FOLD):
            new = tuple(np.concatenate([p[i] for p in self._pending])
                        for i in range(4))
            self._pending, self._pending_n = [], 0
            self._events = self._grown(new)
            index = append_events(self.nbr_index, *new)
            if index is None:
                index = build_neighbor_index(*self._events, self.cfg.n_nodes,
                                             self.device)
                self._fold_rebuilds += 1
            else:
                self._fold_appends += 1
            self.nbr_index = index

    def _grown(self, new) -> Tuple[np.ndarray, ...]:
        """``_events`` followed by the columns ``new``, as views of the
        capacity buffers: amortised O(len(new)). Rows a handed-out tuple
        holds are never written; a tuple other than the last one handed
        out (a caller put back an older state) is first copied into fresh
        buffers."""
        n, k = len(self._events[0]), len(new[0])
        if (self._events is not self._events_out
                or n + k > len(self._events_buf[0])):
            cap = 2 * (n + k)
            self._events_buf = tuple(
                np.empty(cap, np.result_type(np.asarray(c).dtype, d.dtype))
                for c, d in zip(self._events, new))
            for buf, c in zip(self._events_buf, self._events):
                buf[:n] = c
        for buf, c in zip(self._events_buf, new):
            buf[n: n + k] = c
        self._events_out = tuple(buf[: n + k] for buf in self._events_buf)
        return self._events_out

    # ------------------------------------------------------------ requests

    def _map_ids(self, ids) -> np.ndarray:
        """External node ids → internal row ids (the interleave's, where
        the config trained with it)."""
        ids = np.asarray(ids, np.int64)
        return ids if self._id_perm is None else self._id_perm[ids]

    def _request(self, src, dst, t):
        """Host columns → (src, dst, t) on the device, after checking the
        node ids on the host and mapping them to internal ids."""
        check_node_ids(self.cfg.n_nodes, src, dst)
        ids = lambda x: torch.as_tensor(
            self._map_ids(x).astype(np.int32)).to(self.device)
        return ids(src), ids(dst), torch.as_tensor(
            np.asarray(t, np.float32)).to(self.device)

    def _queries(self, src, dst, t,
                 with_neg: bool = True) -> Optional[TpprQueries]:
        """Read-only T-PPR top-k at the query times, fields [M, nb·b, k]:
        src‖dst‖dst blocks when ``with_neg`` (the training layout),
        src‖dst for plain scoring. Under the pruning strategy one BFS over
        the adjacency index; None for a tower that reads no T-PPR query."""
        if not self.cfg.uses_tppr:
            return None
        with span(QUERY):
            cols = [src, dst] + ([dst] if with_neg else [])
            if self.cfg.tppr_strategy == "pruning":
                return pruned_queries(self.cfg, self.nbr_index,
                                      self._alpha_beta, cols, t)
            return flat_blocks(read_topk(self.index_state,
                                         torch.stack(cols, dim=1), t,
                                         self.cfg.n_tppr, self.cfg.topk))

    def score(self, src, dst, t) -> np.ndarray:
        """P(interaction) for each (src, dst) candidate at its timestamp."""
        return self._scored(src, dst, t)

    def _scored(self, src, dst, t, mean: bool = False) -> np.ndarray:
        """``score``'s path, one ``zebra.score`` span: the request, the
        probabilities (their member mean under ``mean``) and the host read
        of them."""
        with span(SCORE), torch.no_grad():
            with span(REQUEST):
                cols = self._request(src, dst, t)
            p = self._probs(*cols, mean=mean)
            with span(READBACK):
                return p.cpu().numpy()

    def _probs(self, src, dst, t, mean: bool = False) -> torch.Tensor:
        """Link probabilities on the device: [B], or [S, B] for the members
        of an ensemble ([B], their mean, under ``mean``)."""
        b = src.shape[0]
        q = self._queries(src, dst, t, with_neg=False)
        with span(FORWARD):
            nodes2 = torch.cat([src, dst])
            times = None if self.cfg.uses_tppr else torch.cat([t, t])
            emb = _forward(self.cfg, self.params, self.mem, self.edge_feats,
                           nodes2, q, offs=self._offs, times=times,
                           nbr_index=self.nbr_index)
            logit = affinity_score(self.params, emb[..., :b, :],
                                   emb[..., b:, :], self.cfg.mxu_dtype)
            p = torch.sigmoid(logit)
            return p.mean(0) if mean else p

    def observe(self, src, dst, t, eidx) -> None:
        """Ingest observed interactions: fold them into the adjacency index
        (pruning and the recursive towers; see ``rebuild_every``) or stream
        them through the T-PPR index (streaming diffusion, updated in place;
        edge ids must stay below 2^24, the scan checks), then store and
        commit their messages into memory (the eval protocol). Under a
        message-source flag the messages carry the embeddings of an eval
        forward at [src; dst; dst], after the fold (an event's recursive
        query sees the earlier events of the call) and on the pre-edge
        T-PPR queries.

        Every observed event is valid, so the protocol takes no mask and
        reads nothing back. On the card, without a message-source flag, it
        replays a CUDA graph of the call's length (``train/graphs.py:
        ProtocolGraphs``: the first call of a length captures it, a few
        lengths are held, others run eagerly); ``protocol_captures``,
        ``protocol_replays`` and ``protocol_eager`` count the calls."""
        with span(OBSERVE), torch.no_grad():
            with span(REQUEST):
                cols = self._request(src, dst, t)
                self._append_events(self._map_ids(src), self._map_ids(dst),
                                    t, eidx)
                src, dst, t = cols
                eidx = torch.as_tensor(np.asarray(eidx, np.int32)).to(
                    self.device)
            q = None
            if self.index_state is not None:
                with span(SCAN):
                    valid = torch.ones(src.shape[0], dtype=torch.bool,
                                       device=self.device)
                    if self.cfg.need_emb:
                        # the scan's extraction is pre-edge: the queries an
                        # eval forward at these events reads
                        self.index_state, q = streaming_scan(
                            self.index_state, self._tppr, src, dst, dst, t,
                            eidx, valid)
                        q = flat_blocks(q)
                    else:
                        self.index_state = fill_scan(self.index_state,
                                                     self._tppr, src, dst, t,
                                                     eidx, valid)
            elif self.cfg.need_emb:
                q = self._queries(src, dst, t)
            self.mem = self._updated_mem(q, src, dst, t, eidx)

    def _updated_mem(self, q: Optional[TpprQueries], src, dst, t,
                     eidx) -> MemoryState:
        """Eval-protocol memory update for observe(), every member of an
        ensemble at once, replayed from its graph where
        :class:`ProtocolGraphs` holds or captures one; under a
        message-source flag with the embeddings of an eval forward over
        the queries ``q`` (src‖dst‖dst blocks)."""
        with span(PROTOCOL):
            bound = Bound(self.cfg, self.params, self.mem, self.edge_feats,
                          None, self._offs)
            if self._protocol.run(bound, (src, dst, t, eidx)):
                return self.mem
            src_emb = dst_emb = None
            if self.cfg.need_emb:
                b = src.shape[0]
                emb = _forward(self.cfg, self.params, self.mem,
                               self.edge_feats, torch.cat([src, dst, dst]), q,
                               offs=self._offs, times=torch.cat([t, t, t]),
                               nbr_index=self.nbr_index)
                src_emb, dst_emb = emb[..., :b, :], emb[..., b: 2 * b, :]
            return eval_protocol(self.cfg, self.params, self.mem,
                                 self.edge_feats, src, dst, t, eidx, None,
                                 self._offs, src_emb, dst_emb)


class EnsemblePredictor(LinkPredictor):
    """Deep-ensemble serving over a seed-parallel snapshot
    (``zebra_tpu/serve.py:EnsemblePredictor``): ``params`` carry the [S]
    seed axis of one ``--parallel_runs`` run and ``mem`` its [S, N, ...]
    tables, the T-PPR index is shared (its evolution does not depend on the
    model), and ``score`` returns the mean link probability of the S
    members from one batched pass. ``observe`` runs the shared index scan
    once (one ``santa_scan`` launch on the card; under the pruning strategy
    one fold of the shared adjacency index), then the eval memory protocol
    of all members at once. The members' tables are held flat,
    [S·N, ...], as the seed-parallel Trainer holds them.

    Build with ``LinkPredictor.from_checkpoint(path, ensemble=True)`` or
    ``EnsemblePredictor.from_trainer(seed_parallel_trainer)``; ``cfg`` is
    the members' (single-seed) configuration."""

    _stacked = True

    def __init__(self, cfg: Config, params, mem: MemoryState,
                 index_state: Optional[TpprState], edge_feats,
                 nbr_index: Optional[NeighborIndex] = None,
                 events: Optional[Tuple[np.ndarray, ...]] = None,
                 rebuild_every: int = 1, device=None,
                 internal_ids: bool = False):
        n_models = next(iter(params.parameters())).shape[0]
        super().__init__(cfg, params, MemoryState(*(
            x.reshape((-1,) + x.shape[2:]) for x in mem)), index_state,
            edge_feats, nbr_index, events, rebuild_every, device,
            internal_ids)
        self._offs = torch.arange(n_models, dtype=torch.int64,
                                  device=self.device) * cfg.n_nodes

    @property
    def n_models(self) -> int:
        return int(self._offs.shape[0])

    def score(self, src, dst, t) -> np.ndarray:
        """The mean member probability for each (src, dst) candidate."""
        return self._scored(src, dst, t, mean=True)

    def member_scores(self, src, dst, t) -> np.ndarray:
        """Per-member probabilities [S, B] (``score`` is their mean)."""
        return self._scored(src, dst, t)
