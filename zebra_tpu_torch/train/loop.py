"""The trainer (counterpart of ``zebra_tpu/train/loop.py``):
``Trainer(cfg, splits, edge_feats)``, then ``fit()``, or ``train_epoch()``,
``validate()`` and ``test()`` by hand.

Per epoch: zeroed memory and an empty index, then the train stream in
superchunks. For each superchunk the host schedules the waves of the index
scan (this epoch's negatives included, as their rows are read), the device
runs the wave scan (``index/waves.py``: one ``santa_waves`` launch per
superchunk on the card; row-sharded, one ``santa_merge`` launch per wave),
which extracts every event's T-PPR queries before its update, and
``run_phase`` trains over the chunk's batches with them. The index state
at the end of the train stream is the state validation starts from. Under
the pruning strategy there is no index state and no wave scan: each
batch's queries are a bounded BFS over an adjacency index built
once, of the train graph in training and of the full graph in validate
and test (``index/pruning.py``); a stop request then takes effect at the
end of the epoch, as in the JAX package. The towers other than diffusion
keep no index state and run no wave scan and no BFS under either strategy
(``Config.uses_tppr``); the recursive ones search those adjacency indices,
and a stop request takes effect at the end of the epoch.

Under a ``torch.profiler`` the epoch's host work lands in the program's
spans (``utils/profiling.py``): ``zebra.reset``, ``zebra.negatives``, per
superchunk ``zebra.wave_plan`` and ``zebra.wave_scan`` (with the columns'
``zebra.read_ids`` inside), ``run_phase``'s ``zebra.batch`` spans (with
``zebra.capture`` where a batch's CUDA graphs are captured), then
``zebra.readback``; evaluation's phases take the same spans. On the card
the full train batches of the streaming diffusion path replay CUDA graphs
(``train/graphs.py``), bound to the memory tables that each epoch's reset
zeroes in place.

validate: flush pending messages (the train→eval transition), run the
transductive val stream from (train-end memory, train-end index), keep that
val-end state, run the inductive val stream from the unflushed train-end
state, then restore the val-end state. test: the transductive and the
inductive test streams, each from the val-end state. Under ``host_backup``
(chosen by the device-memory guard, ``train/memory_budget.py``, where only
it fits) the backups wait in host memory and the device holds one set of
tables.

fit: epochs of train_epoch then validate, early stopping on the
transductive val AP, the best epoch's (params, memory) in
``checkpoint_path``, a full-state file every ``state_every`` epochs, and
test() at the end. ``request_stop`` (the CLI's SIGTERM handler) ends the
epoch after its current superchunk; fit then writes a resumable state file
with the cursor, and ``fit(resume_from=...)`` continues exactly.

Negatives are drawn on the host: eval negatives once, from samplers seeded
0/2/3 (the inductive val stream reuses the val sampler); train negatives
every epoch from (base, epoch). The same inputs and seed give the JAX
Trainer's negatives. The Trainer runs on CUDA unless ``device="cpu"`` is
passed.

Seed-parallel (``cfg.parallel_runs`` = S > 1): S independent runs, seeds
``cfg.seed + s``, advance together in one pass (``train/phase.py``). Each
seed has its own params (a leading [S] axis on every leaf), Adam state
(:class:`~zebra_tpu_torch.train.step.SeedAdam`, lr ``parallel_lr[s]``),
memory (rows [s·N, (s+1)·N) of the flat tables ``self.mem``), dropout
generator and train negatives (the draw a single-seed Trainer with that
seed makes). The index scan is shared: negatives are only read for
extraction, so one scan per superchunk, scheduled against every seed's
negatives, serves all seeds. Phase results hold [S] arrays; ``fit`` keeps a
stopper and a best snapshot per seed and returns the mean, σ and the
per-seed values.

Seed-sharded (``cfg.n_devices`` = D > 1, ``zebra_tpu_torch/parallel/``):
one process per device, and rank r holds the global lanes [r·S/D,
(r+1)·S/D) alone (seeds, lrs, generators and negative bases keyed by the
global lane); every rank scans the index from the same stream, scheduled
against its own lanes' negatives (a merge of rows [W, 2 + S/D, F]), so the
index is bit-equal on every rank. A phase gathers its per-batch metrics of
every lane onto every rank once, at its end; a stop request and a
compaction overflow are agreed by every rank; rank 0 gathers the lanes of
a state file and writes it in the one-process layout.

Row-sharded (``cfg.n_devices`` = D > 1 with one seed; the JAX package's
``shard_memory``/``shard_index_state``/``shard_batch`` layout): rank r
holds the node rows [r·N/D, (r+1)·N/D) of the memory tables and of the
index, and the params, Adam's state and the dropout generator whole, the
same on every rank. A wave's rows come through the row exchange
(``parallel/exchange.py``), every rank merges every lane and writes the
rows it owns; the batches run block by block (``run_phase_rows``: rank r
takes the events [r·b/D, (r+1)·b/D) of each batch), with the gradients
summed over the ranks; under pruning and the recursive towers every rank
holds the adjacency indices whole and searches them for the whole batch.
Every option of one process runs so. The index and the memory tables,
gathered, are those of one process. With owner-aligned waves (``--owner_aligned_waves``;
auto: on where the ranks span more than one host,
:func:`resolve_owner_aligned`) the scheduler puts an edge in its source
owner's lane block, and the id interleave (``--interleave_node_ids``;
auto: where aligned waves run) relabels the node ids round-robin over the
ranks first (:func:`permute_splits`): the samplers stay in raw id space
and their draws map afterwards (``_neg_ids``). The state file holds the
rows in the one-process layout, written by rank 0, and records the
interleave's shard count for serving."""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from zebra_tpu_torch.config import Config, torch_dtype
from zebra_tpu_torch.data.dataset import Data, DatasetSplits
from zebra_tpu_torch.data.sampler import RandEdgeSampler
from zebra_tpu_torch.parallel.distributed import broadcast_one_to_all
from zebra_tpu_torch.parallel.exchange import RowExchange
from zebra_tpu_torch.parallel.mesh import make_mesh
from zebra_tpu_torch.parallel.sharding import (
    agree_max,
    all_gather_blocks,
    all_gather_lanes,
    barrier,
    gather_blocks,
    interleave_permutation,
    local_lanes,
    local_rows,
    rows_per_rank,
    take_lanes,
    take_rows,
)
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    TpprState,
    check_id_width,
    init_tppr_state,
)
from zebra_tpu_torch.index.waves import WavePlan, plan_waves, wave_scan_chunk
from zebra_tpu_torch.models.memory import MemoryState, init_memory
from zebra_tpu_torch.train.memory_budget import (
    adjacency_bytes,
    check_memory_budget,
    fetch_bytes,
    replay_bytes,
)
from zebra_tpu_torch.models.tgn import init_seed_params, init_tgn_params
from zebra_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from zebra_tpu_torch.train.early_stopping import EarlyStopMonitor
from zebra_tpu_torch.train.graphs import BatchGraphs, Bound
from zebra_tpu_torch.train.phase import (
    RowPlan,
    Stream,
    plan_rows,
    rows_metrics,
    run_phase,
    run_phase_rows,
)
from zebra_tpu_torch.train.step import (
    flush_pending,
    flush_pending_,
    flush_pending_seeds,
    lane_lrs,
    lazy_position_count,
    make_optimizer,
    resolve_lazy_cap,
)
from zebra_tpu_torch.utils.profiling import (
    NEGATIVES,
    READBACK,
    RESET,
    WAVE_PLAN,
    WAVE_SCAN,
    PhaseTimers,
    mark,
    marking,
    part,
    span,
    trace_context,
)

logger = logging.getLogger("zebra_tpu_torch")

# eval negative-sampling seeds; the inductive val stream shares the val
# sampler
SEED_VAL, SEED_TEST, SEED_NN_TEST = 0, 2, 3


def resolve_owner_aligned(cfg: Config, n_hosts: int) -> bool:
    """Whether a row-sharded run aligns its waves to the row owners
    (``zebra_tpu/train/loop.py:resolve_owner_aligned``): the flag when
    given; auto (None) on where the ranks span more than one host. The JAX
    package's auto asks for more than one process, and a one-host JAX mesh
    is one process; the port's ranks on one host stand in for that mesh,
    so ``--n_devices 2`` on one host resolves to unaligned waves in both."""
    if cfg.owner_aligned_waves is not None:
        return bool(cfg.owner_aligned_waves)
    return n_hosts > 1


def permute_splits(splits: DatasetSplits, perm: np.ndarray) -> DatasetSplits:
    """Every split's node ids relabelled through ``perm`` (times, edge ids
    and labels unchanged; ``zebra_tpu/train/loop.py:_permute_splits``). The
    model is equivariant in node ids, so a permuted run matches the plain
    one up to the top-k's tie order (ties break by neighbor id)."""
    pd = lambda d: Data(perm[d.sources], perm[d.destinations], d.timestamps,
                        d.edge_idxs, d.labels)
    return DatasetSplits(
        full=pd(splits.full), train=pd(splits.train), val=pd(splits.val),
        test=pd(splits.test), new_node_val=pd(splits.new_node_val),
        new_node_test=pd(splits.new_node_test), n_nodes=splits.n_nodes,
        n_edges=splits.n_edges)


@dataclass
class PhaseResult:
    ap: float                    # seed-parallel: these four are [S] arrays
    auc: float
    acc: float
    loss: float = 0.0
    seconds: float = 0.0
    index_seconds: float = 0.0   # host clock in the index: scheduling and
                                 # enqueueing the waves, or the BFS calls
                                 # (the device runs them behind the host)
    waves: int = 0               # index waves run (on the card one
                                 # santa_waves launch per superchunk, or,
                                 # row-sharded, one santa_merge per wave)
    gather_seconds: float = 0.0  # host clock in the gather of every
                                 # rank's lanes of the metrics (sharded)
    overflow: float = 0.0        # >0: a train batch overflowed the lazy
                                 # compaction's cap (its rows were wrong;
                                 # train_epoch reruns the epoch)
    per_batch: Optional[np.ndarray] = field(  # [real batches, 4]: loss,
        default=None, repr=False)             # ap, auc, acc per batch
                                              # ([real batches, S, 4])


class PhaseStream(NamedTuple):
    """A phase's stream on the device, its host columns (for the wave
    scheduler) and its padding geometry."""

    stream: Stream
    host: Dict[str, np.ndarray]
    n_batches: int       # padded batch count (= per-chunk count · n_chunks)
    real_batches: int    # batches holding any real event
    n_chunks: int

    def n_valid(self) -> np.ndarray:
        """Valid events per batch."""
        return self.host["valid"].reshape(self.n_batches, -1).sum(1)


class Trainer:
    def __init__(self, cfg: Config, splits: DatasetSplits,
                 edge_feats: Optional[np.ndarray] = None,
                 node_feats: Optional[np.ndarray] = None, device=None):
        # one device per process: a rank of a seed-sharded run holds its
        # own seeds (cfg.n_devices ranks; one, this process, by default)
        self.mesh = mesh = make_mesh(cfg.n_devices, device)
        self.device = dev = mesh.device
        # ids are 1-based with 0 as padding; N rounds up to a multiple of 128
        # (the JAX package's row-sharding alignment, kept so both packages
        # hold tables of one shape)
        n_nodes = -(-(splits.n_nodes + 1) // 128) * 128
        cfg = cfg.replace(n_nodes=n_nodes, n_edges=splits.n_edges + 1)
        real_edge_feats = edge_feats is not None and not cfg.ignore_edge_feats
        if edge_feats is None or cfg.ignore_edge_feats:
            edge_feats = np.zeros((cfg.n_edges, 1), np.float32)
        cfg = cfg.replace(edge_dim=int(edge_feats.shape[1]),
                          real_edge_feats=real_edge_feats)
        if node_feats is not None and not cfg.ignore_node_feats:
            # the towers represent nodes by their memory rows, as the
            # reference's active path does
            logger.warning(
                "node_feats provided but not used: every embedding module "
                "represents nodes by their memory rows, like the "
                "reference's active path (tgn_model.py:85). Pass "
                "--ignore_node_feats to silence.")
        if cfg.keeps_tppr_index:
            # the packed T-PPR rows hold ids as f32 values
            check_id_width(cfg.n_nodes, cfg.n_edges)
        # one seed over a mesh: its node rows split over the ranks, which
        # exchange rows on the device
        self.exchange: Optional[RowExchange] = None
        self._rows = n_nodes
        if mesh.size > 1 and cfg.n_seeds == 1:
            if cfg.bs % mesh.size:
                raise ValueError(
                    f"bs ({cfg.bs}) must be a multiple of the mesh size "
                    f"({mesh.size}): each rank takes an equal block of "
                    "every batch's events")
            self._rows = rows_per_rank(n_nodes, mesh.size)
            self.exchange = RowExchange(mesh, n_nodes)
        aligned = (self.exchange is not None
                   and resolve_owner_aligned(cfg, self.exchange.hosts))
        # the waves' lane blocks: one per rank under owner alignment
        self._wave_shards = mesh.size if aligned else 1
        if aligned and cfg.wave_cap % mesh.size:
            raise ValueError(f"wave_cap {cfg.wave_cap} must be a multiple of "
                             f"n_shards {mesh.size}")
        # the id interleave (auto: where aligned waves run); the samplers
        # stay in raw id space and their draws map through it (_neg_ids)
        use_il = cfg.interleave_node_ids
        if use_il is None:
            use_il = aligned
        self._id_perm = None
        sampler_splits = splits
        if use_il and mesh.size > 1:
            self._id_perm = interleave_permutation(n_nodes, mesh.size)
            cfg = cfg.replace(interleave_shards=mesh.size)
            splits = permute_splits(splits, self._id_perm)
            logger.info("node ids interleaved over %d shards for owner-"
                        "aligned scheduling (--no_interleave_node_ids to "
                        "disable)", mesh.size)
        elif cfg.interleave_node_ids and mesh.size <= 1:
            logger.warning(
                "--interleave_node_ids has no effect without a >1-device "
                "mesh (the permutation exists to balance owner-aligned lane "
                "blocks across shards); running with raw ids")
        self.cfg, self.splits = cfg, splits
        self.edge_feats = torch.as_tensor(
            np.asarray(edge_feats, np.float32)).to(dev)

        tr, fu = sampler_splits.train, sampler_splits.full
        self.train_sampler = RandEdgeSampler(tr.sources, tr.destinations)
        self.val_sampler = RandEdgeSampler(fu.sources, fu.destinations,
                                           seed=SEED_VAL)
        self.test_sampler = RandEdgeSampler(fu.sources, fu.destinations,
                                            seed=SEED_TEST)
        self.nn_test_sampler = RandEdgeSampler(
            sampler_splits.new_node_test.sources,
            sampler_splits.new_node_test.destinations, seed=SEED_NN_TEST)
        self._streams: Dict[str, PhaseStream] = {
            name: self._upload_stream(data, sampler)
            for name, data, sampler in (
                ("train", splits.train, None),
                ("val", splits.val, self.val_sampler),
                ("test", splits.test, self.test_sampler),
                ("nn_val", splits.new_node_val, self.val_sampler),
                ("nn_test", splits.new_node_test, self.nn_test_sampler),
            )
        }
        # eval negatives are fixed, so their wave plans (and row-sharded
        # batch plans) are made once
        self._eval_plans: Dict[str, Dict[int, WavePlan]] = {}
        self._eval_row_plans: Dict[str, Dict[int, RowPlan]] = {}
        # adjacency indices of the pruning strategy and the recursive
        # towers: the train graph in training, the full graph in validate
        # and test
        self.train_nbr_index = self.full_nbr_index = None
        if cfg.needs_adjacency:
            # in the (possibly permuted) id space the streams query with
            self.train_nbr_index, self.full_nbr_index = (
                build_neighbor_index(d.sources, d.destinations, d.timestamps,
                                     d.edge_idxs, cfg.n_nodes, dev)
                for d in (splits.train, splits.full))
        self._tppr = TpprParams.create(cfg.alpha_list, cfg.beta_list,
                                       cfg.topk)

        # the seed lanes this rank holds (global ids; all S on one device,
        # the one seed on every rank of a row-sharded mesh) and whether the
        # state is stacked on a seed axis (S > 1)
        self._stacked = cfg.n_seeds > 1
        self._lanes = lanes = (range(1) if self.exchange is not None else
                               local_lanes(cfg.n_seeds, mesh.size, mesh.rank))
        self._n_seeds = n_seeds = len(lanes)

        # the base of the per-epoch train negatives: the first draw of a
        # RandomState seeded with cfg.seed (random under enable_random); per
        # seed, the base a single-seed Trainer with seed cfg.seed + g draws
        if not self._stacked:
            draw = np.random if cfg.enable_random else np.random.RandomState(
                cfg.seed)
            self._neg_base = int(draw.randint(0, 2**31 - 1))
            if cfg.enable_random and self.exchange is not None:
                # every rank draws; rank 0's draw holds for all
                self._neg_base = int(broadcast_one_to_all(
                    np.asarray([self._neg_base], np.int64))[0])
        else:
            if cfg.enable_random:
                bases = np.random.randint(0, 2**31 - 1,
                                          cfg.n_seeds).astype(np.int64)
                if mesh.size > 1:
                    # every rank draws; rank 0's draw holds for all
                    bases = broadcast_one_to_all(bases)
            else:
                bases = np.asarray(
                    [np.random.RandomState(cfg.seed + g).randint(0, 2**31 - 1)
                     for g in range(cfg.n_seeds)], np.int64)
            self._neg_base = take_lanes(bases, lanes)
        self._epoch_id = 0

        # local lane s owns rows [s·N, (s+1)·N) of the flat memory tables
        self._offs = None
        if not self._stacked:
            self.set_params(init_tgn_params(
                cfg, torch.Generator().manual_seed(cfg.seed), dev))
        else:
            self._offs = torch.arange(n_seeds, dtype=torch.int64,
                                      device=dev) * cfg.n_nodes
            self.set_params(init_seed_params(cfg, dev, lanes))
        # dropout masks, one generator per seed; JAX's rbg masks cannot be
        # reproduced
        gens = [torch.Generator(dev).manual_seed(cfg.seed + g)
                for g in lanes]
        self._dropout = gens if self._stacked else gens[0]
        # validate/test's table backups in host memory, or on the device
        # (host_backup None: the guard decides); the host buffers are
        # pinned on a card, made at the first validate and reused
        world = mesh.size if self.exchange is not None else 1
        self.host_backup = check_memory_budget(
            cfg, n_seeds, dev, self._rows,
            adjacency_bytes(self.train_nbr_index, self.full_nbr_index)
            + fetch_bytes(cfg, world) + replay_bytes(cfg, world))
        self._host_tables: Dict[str, MemoryState] = {}
        self.host_copy_seconds = 0.0
        self.mem, self.index_state = self._fresh_state()

        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        self.checkpoint_path = os.path.join(cfg.checkpoint_dir,
                                            cfg.run_name() + ".ckpt")
        # the next train superchunk of an unfinished epoch (0 between epochs)
        self._chunk_cursor = 0
        # set by request_stop; read on the host at superchunk boundaries
        self._stop_requested = False
        # the early-stop monitor's fields riding in fit's state files
        self._fit_state: Optional[Dict] = None
        # index waves run so far; of them the row-sharded scans' waves, one
        # exchange and one santa_merge launch each on the card; and the
        # superchunks scanned in one piece, one santa_waves launch each
        self.index_waves = 0
        self.index_sharded_waves = 0
        self.index_scans = 0
        # the CUDA graphs of the full streaming train batch, bound to the
        # memory tables the epoch reset keeps (train/graphs.py)
        self._graphs: Optional[BatchGraphs] = BatchGraphs()
        # set once a batch overflowed the lazy compaction's cap: training
        # then runs per position for the rest of the run
        self._lazy_fallback = False
        # one record per epoch of fit: seconds, rates, AP, state-file write
        self.epoch_log: List[Dict[str, float]] = []

    def request_stop(self) -> None:
        """Ask the running ``fit`` to stop after the current superchunk and
        write a resumable state file. Only sets a flag, so a signal handler
        may call it. In a seed-sharded run a request on any rank stops every
        rank at the same superchunk."""
        self._stop_requested = True

    def _agree_stop(self) -> bool:
        """Whether a stop was requested, on any rank of the mesh: read at
        superchunk boundaries, where every rank asks (a rank that stopped
        alone would leave the others waiting in its next collective)."""
        if self.mesh.size > 1:
            self._stop_requested = agree_max(self.mesh,
                                             self._stop_requested) > 0
        return self._stop_requested

    @staticmethod
    def _stopper_state(stopper: EarlyStopMonitor) -> Dict:
        """The early-stop monitor's fields that ride in a state file."""
        return {
            "num_round": stopper.num_round,
            "epoch_count": stopper.epoch_count,
            "best_epoch": stopper.best_epoch,
            "last_best": (None if stopper.last_best is None
                          else float(stopper.last_best)),
        }

    @property
    def graph_captures(self) -> int:
        """Captures of the train batch's CUDA graphs so far."""
        return self._graphs.captures

    @property
    def graph_batches(self) -> int:
        """Full train batches replayed from the CUDA graphs so far."""
        return self._graphs.replays

    @property
    def eager_batches(self) -> int:
        """Train batches that ran eagerly so far (on the CPU: every one)."""
        return self._graphs.eager

    def set_params(self, params) -> None:
        """Train ``params`` (an ``nn.ModuleDict`` on this Trainer's device)
        from here on, with a fresh Adam state."""
        self.params = params.to(self.device).requires_grad_(True)
        self.optimizer = make_optimizer(self.cfg, self.params, self._lanes)

    # ---------------------------------------------------------------- helpers

    def _fresh_state(self, whole: bool = False,
                     tables: Optional[MemoryState] = None
                     ) -> Tuple[MemoryState, Optional[TpprState]]:
        """Zeroed memory (S·N flat rows for S seeds; a row-sharded rank's
        N/D, or all N rows of one seed under ``whole``) and an empty index
        (None where no T-PPR index is kept: the pruning strategy and the
        towers other than diffusion). ``tables``, this Trainer's own, are
        zeroed in place and returned in place of new ones."""
        cfg = self.cfg
        rows = cfg.n_nodes if whole else self._rows
        if tables is not None:
            mem = tables
            for x in mem:
                x.zero_()
        else:
            mem = init_memory(rows * (1 if whole else self._n_seeds),
                              cfg.memory_dim, cfg.msg_table_dim,
                              torch_dtype(cfg.message_dtype),
                              torch_dtype(cfg.memory_dtype),
                              device=self.device)
        if not cfg.keeps_tppr_index:
            return mem, None
        return mem, init_tppr_state(cfg.n_tppr, rows, cfg.topk,
                                    device=self.device)

    def _neg_ids(self, negs: np.ndarray) -> np.ndarray:
        """Sampler draws (raw id space) → the streams' ids (through the
        interleave, when it runs)."""
        return negs if self._id_perm is None else self._id_perm[negs]

    def _upload_stream(self, data: Data, sampler) -> PhaseStream:
        """Pad a stream to whole batches and to equal superchunks of whole
        batches, draw its negatives when a seeded sampler is given, and put
        its columns on the device. Padding events are invalid (node 0,
        edge 0, time 0)."""
        bs = self.cfg.bs
        n = data.n_interactions
        real_batches = max(1, -(-n // bs))
        n_chunks = min(real_batches,
                       max(1, -(-(real_batches * bs) // self.cfg.index_chunk)))
        per_chunk = -(-real_batches // n_chunks)
        n_batches = per_chunk * n_chunks
        pad = n_batches * bs - n

        def p(a, dtype):
            a = np.asarray(a, dtype)
            return np.concatenate([a, np.zeros(pad, dtype)])

        negs = (self._neg_ids(sampler.sample_eval_negatives(n, bs))
                if sampler is not None and n > 0 else np.zeros(n, np.int64))
        host = {
            "src": p(data.sources, np.int32),
            "dst": p(data.destinations, np.int32),
            "neg": p(negs, np.int32),
            "t": p(data.timestamps, np.float32),
            "eidx": p(data.edge_idxs, np.int32),
            "valid": np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        }
        stream = Stream(*(torch.from_numpy(host[f]).to(self.device)
                          for f in Stream._fields))
        return PhaseStream(stream, host, n_batches, real_batches, n_chunks)

    def _draw_train_negs(self, epoch_id: int) -> np.ndarray:
        """This epoch's train negatives, padded to the stream's length: a
        draw from a RandomState seeded with (base, epoch). Seed-parallel:
        [S, E] (this rank's S lanes), row s the draw of a single-seed
        Trainer with the lane's seed cfg.seed + g."""
        n = self.splits.train.n_interactions
        pad = len(self._streams["train"].host["src"]) - n

        def draw(base):
            rs = np.random.RandomState(
                (int(base) + 0x9E3779B1 * (epoch_id + 1)) % (2**32))
            _, negs = self.train_sampler.sample_with(rs, n)
            negs = self._neg_ids(negs)
            return np.concatenate([negs, np.zeros(pad, negs.dtype)]).astype(
                np.int32)

        if not self._stacked:
            return draw(self._neg_base)
        return np.stack([draw(b) for b in self._neg_base])

    def _wave_plans(self, name: str, negs: np.ndarray,
                    chunks: range) -> Dict[int, WavePlan]:
        """The wave plan of each superchunk in ``chunks`` of stream ``name``
        under the negatives ``negs`` ([E], or [E, S]: one scan for all
        seeds; host scheduling, then one upload per chunk)."""
        ps = self._streams[name]
        host = ps.host
        chunk = len(host["src"]) // ps.n_chunks
        plans = {}
        rows = None if self.exchange is None else local_rows(
            self.mesh.rank, self._rows)
        for ci in chunks:
            sl = slice(ci * chunk, (ci + 1) * chunk)
            with span(WAVE_PLAN):
                plans[ci] = plan_waves(
                    host["src"][sl], host["dst"][sl], negs[sl],
                    host["valid"][sl], self.cfg.n_nodes, self.cfg.wave_cap,
                    self.device, self._wave_shards, rows)
        return plans

    def _row_plans(self, name: str, negs: np.ndarray,
                   chunks: range) -> Dict[int, RowPlan]:
        """The row-sharded batch plan (``train/phase.py:plan_rows``) of each
        superchunk in ``chunks`` of stream ``name`` under the negatives
        ``negs``."""
        ps = self._streams[name]
        host = ps.host
        chunk = len(host["src"]) // ps.n_chunks
        return {ci: plan_rows(*(c[ci * chunk: (ci + 1) * chunk] for c in (
                    host["src"], host["dst"], negs, host["valid"])),
                    self.cfg.bs, self.mesh.size, self.mesh.rank, self._rows,
                    self.device)
                for ci in chunks}

    def _phase(self, name: str, train: bool,
               index_state: Optional[TpprState], start_chunk: int = 0,
               max_chunks: Optional[int] = None
               ) -> Tuple[Optional[TpprState], PhaseResult]:
        """One pass over stream ``name``: per superchunk, the wave scan of
        the index, then the batches (pruning: the batches, each with its
        BFS; the other towers: the batches alone). Updates ``self.mem``,
        ``index_state`` and, in training, the parameters in place; reads the
        metrics back once, at the end.

        Runs the superchunks from ``start_chunk`` on, at most
        ``max_chunks`` of them; in training it advances the cursor after
        each and, where waves run, stops after the current one once a stop
        was requested. The metrics cover the superchunks that ran."""
        t0 = time.perf_counter()
        cfg = self.cfg
        # after a compaction overflow training runs per position (sticky)
        run_cfg = (cfg.replace(lazy_unique_cap=0)
                   if train and self._lazy_fallback else cfg)
        wave_scan = cfg.keeps_tppr_index
        ps = self._streams[name]
        stream = ps.stream
        stop = ps.n_chunks if max_chunks is None else min(
            ps.n_chunks, start_chunk + max_chunks)
        chunks = range(start_chunk, stop)
        if not chunks:
            raise ValueError(
                f"empty superchunk window: start_chunk={start_chunk}, "
                f"max_chunks={max_chunks} select none of the {ps.n_chunks} "
                "chunks")
        plans = row_plans = None
        row_sharded = self.exchange is not None
        if train:
            with span(NEGATIVES):
                # [E], or [E, S]: the phases' layout of one negative per seed
                negs = np.ascontiguousarray(
                    self._draw_train_negs(self._epoch_id).T)
                stream = stream._replace(
                    neg=torch.from_numpy(negs).to(self.device))
            if wave_scan:
                plans = self._wave_plans(name, negs, chunks)
            if row_sharded:
                row_plans = self._row_plans(name, negs, chunks)
        else:
            if wave_scan:
                if name not in self._eval_plans:
                    self._eval_plans[name] = self._wave_plans(
                        name, ps.host["neg"], range(ps.n_chunks))
                plans = self._eval_plans[name]
            if row_sharded:
                if name not in self._eval_row_plans:
                    self._eval_row_plans[name] = self._row_plans(
                        name, ps.host["neg"], range(ps.n_chunks))
                row_plans = self._eval_row_plans[name]
        # the wave plans' host time; the BFS calls add theirs below
        t_index = time.perf_counter() - t0 if wave_scan else 0.0

        chunk = stream.src.shape[0] // ps.n_chunks
        per_chunk = chunk // cfg.bs
        n_valid = ps.n_valid()
        metrics, waves, scans, bfs_s, overflow = [], 0, 0, 0.0, []
        nbr_index = self.train_nbr_index if train else self.full_nbr_index
        bound = Bound(run_cfg, self.params, self.mem, self.edge_feats,
                      self._dropout if train else None, self._offs)
        mark("start")
        for ci in chunks:
            cs = Stream(*(x[ci * chunk: (ci + 1) * chunk] for x in stream))
            if wave_scan:
                ti = time.perf_counter()
                with part(WAVE_SCAN):
                    index_state, queries = wave_scan_chunk(
                        index_state, self._tppr, *cs, plans[ci], self.exchange)
                    if cfg.profile and self.device.type == "cuda":
                        # the index's share covers the device's work, at
                        # the cost of the overlap with the towers
                        torch.cuda.synchronize(self.device)
                t_index += time.perf_counter() - ti
                waves += plans[ci].n_waves
                scans += 1
            else:
                # the BFS's index, or none for a tower without T-PPR
                queries = nbr_index if cfg.uses_tppr else None
            batches = n_valid[ci * per_chunk: (ci + 1) * per_chunk].tolist()
            if row_sharded:
                ran = run_phase_rows(
                    bound, train, self.optimizer, cs, queries, batches,
                    row_plans[ci], self.exchange, nbr_index=nbr_index,
                    phase=name)
                if train and self._graphs is not None:
                    self._graphs.eager += len(batches)
            else:
                ran = run_phase(
                    bound, train, self.optimizer, cs, queries, batches,
                    nbr_index=nbr_index, phase=name,
                    graphs=self._graphs if train else None)
            metrics.append(ran.metrics)
            bfs_s += ran.bfs_s
            overflow += ran.overflow
            if train:
                self._chunk_cursor = ci + 1
                if wave_scan and self._agree_stop():
                    break
        self.index_waves += waves
        if row_sharded:
            self.index_sharded_waves += waves
        else:
            self.index_scans += scans
        t_gather = time.perf_counter()
        with span(READBACK):
            if row_sharded:
                # every rank's block scores, once; the metrics of whole
                # batches
                ran = slice(start_chunk * chunk, start_chunk * chunk
                            + len(metrics) * chunk)
                per_batch = rows_metrics(
                    self.exchange, torch.cat([p for p, _ in metrics]),
                    torch.cat([loss for _, loss in metrics]),
                    stream.valid[ran]).cpu().numpy()
            else:
                # [n_batches, 4], or [n_batches, S, 4]: every lane's, on
                # every rank
                per_batch = all_gather_lanes(self.mesh,
                                             torch.cat(metrics).cpu().numpy())
            t_gather = time.perf_counter() - t_gather
            # a window that starts at chunk c holds the real batches from
            # c·per_chunk on
            real = max(1, min(len(per_batch),
                              ps.real_batches - start_chunk * per_chunk))
            per_batch = per_batch[:real]
            overflowed = agree_max(self.mesh, float(
                torch.stack(overflow[:real]).max()) if overflow else 0.0)
        # [4], or [S, 4] seed-parallel
        mean = per_batch.mean(axis=0)
        if not self._stacked:
            mean = [float(x) for x in mean]
        else:
            mean = list(mean.T)
        return index_state, PhaseResult(
            loss=mean[0], ap=mean[1], auc=mean[2], acc=mean[3],
            seconds=time.perf_counter() - t0,
            index_seconds=t_index + bfs_s, waves=waves,
            gather_seconds=t_gather, overflow=overflowed,
            per_batch=per_batch)

    # ---------------------------------------------------------------- epochs

    def train_epoch(self, start_chunk: int = 0,
                    max_chunks: Optional[int] = None,
                    marks: Optional[list] = None) -> PhaseResult:
        """One training epoch from zeroed memory and an empty index.

        ``start_chunk > 0`` finishes a partly run epoch from restored state
        (no reset); ``max_chunks`` stops after that many superchunks, so the
        caller can ``save_state`` a mid-epoch cursor. The epoch id advances
        and the cursor returns to 0 only when the epoch's last superchunk
        ran. ``marks``, a list (CUDA only), collects (part, CUDA event)
        pairs that time the epoch's parts on the device (the recorder of
        ``utils/profiling.py``, armed for the call): "start", then
        "wave_scan" after each superchunk's wave scan, then the end of
        each part of each batch (``train/phase.py``).

        Under the lazy compaction (``lazy_unique_cap`` ≠ 0) a whole epoch
        starts from a snapshot of the params, Adam's state and the dropout
        generators (the negatives are drawn again from the epoch id). If a
        batch overflowed the cap, the epoch is rerun per position from the
        snapshot, and training stays per position; a windowed epoch cannot
        be rerun and logs an error instead."""
        with marking(marks):
            snapshot = None
            if (start_chunk == 0 and max_chunks is None
                    and not self._lazy_fallback
                    and self._lazy_compaction_active()):
                snapshot = self._snapshot()
            if start_chunk == 0:
                self._reset()
            self.index_state, result = self._phase(
                "train", True, self.index_state, start_chunk, max_chunks)
            if result.overflow > 0 and not self._lazy_fallback:
                self._lazy_fallback = True
                if snapshot is not None:
                    logger.warning(
                        "lazy-update compaction cap overflowed (epoch %d); "
                        "rerunning the epoch on the per-position path and "
                        "switching to it for the rest of the run "
                        "(set --lazy_unique_cap to resize)", self._epoch_id)
                    self._restore_snapshot(snapshot)
                    self._reset()
                    self.index_state, result = self._phase(
                        "train", True, self.index_state)
                else:
                    logger.error(
                        "lazy-update compaction cap overflowed during a "
                        "windowed epoch run; this epoch's updates used the "
                        "compacted path (set --lazy_unique_cap 0 or restart "
                        "from the last checkpoint for exact results)")
            if self._chunk_cursor >= self._streams["train"].n_chunks:
                # epoch complete: the cursor expires
                self._chunk_cursor = 0
                self._epoch_id += 1
            return result

    def _reset(self) -> None:
        """A train epoch's zeroed memory and empty index. The tables the
        batch graphs are bound to are zeroed in place, so a new epoch keeps
        its graphs."""
        with span(RESET):
            self.mem, self.index_state = self._fresh_state(
                tables=None if self._graphs is None else self._graphs
                .tables())

    def _lazy_compaction_active(self) -> bool:
        """Whether the train forward runs the compacted lazy updates (the
        diffusion tower with a cap that shrinks the positions): only then
        can a batch overflow."""
        cfg = self.cfg
        return cfg.uses_tppr and resolve_lazy_cap(
            cfg, lazy_position_count(cfg)) > 0

    def _generators(self) -> list:
        return (list(self._dropout) if isinstance(self._dropout, list)
                else [self._dropout])

    def _snapshot(self):
        """Copies of what a train epoch changes besides memory and index:
        params, Adam's state and the dropout generators' states."""
        return ({k: v.detach().clone()
                 for k, v in self.params.state_dict().items()},
                copy.deepcopy(self.optimizer.state_dict()),
                [g.get_state() for g in self._generators()])

    def _restore_snapshot(self, snapshot) -> None:
        params, opt, gens = snapshot
        # in place, so the optimizer keeps referring to the live tensors
        self.params.load_state_dict(params)
        self.optimizer.load_state_dict(opt)
        for g, state in zip(self._generators(), gens):
            g.set_state(state)
        self._chunk_cursor = 0

    def _flush(self, in_place: bool) -> MemoryState:
        """The train→eval flush of ``self.mem``: new tables, or in place."""
        cfg, mem = self.cfg, self.mem
        if self._stacked:
            return flush_pending_seeds(cfg, self.params, mem, in_place)
        return (flush_pending_ if in_place else flush_pending)(
            cfg, self.params, mem)

    def _to_host(self, key: str) -> MemoryState:
        """Copy the device tables into the host buffers ``key`` (pinned on
        a card; made at the first call and reused)."""
        t0 = time.perf_counter()
        buf = self._host_tables.get(key)
        if buf is None:
            pin = self.device.type == "cuda"
            buf = MemoryState(*(torch.empty(x.shape, dtype=x.dtype,
                                            pin_memory=pin)
                                for x in self.mem))
            self._host_tables[key] = buf
        for b, x in zip(buf, self.mem):
            b.copy_(x)
        self.host_copy_seconds += time.perf_counter() - t0
        return buf

    def _from_host(self, buf: MemoryState) -> None:
        """Copy host buffers back into the device tables."""
        t0 = time.perf_counter()
        for x, b in zip(self.mem, buf):
            x.copy_(b)
        self.host_copy_seconds += time.perf_counter() - t0

    def validate(self) -> Tuple[PhaseResult, PhaseResult]:
        """Transductive and inductive validation with the backup/restore
        protocol; leaves (mem, index) at the val-end state, where test()
        starts.

        Under ``host_backup`` the device holds one set of tables: the
        train-end tables are copied to the host, flushed in place and run
        through the val stream; the val-end tables go to the host while the
        train-end ones come back for the inductive leg, then return. The
        same operations on the same values: bit-equal to the device
        protocol."""
        train_idx = self.index_state
        if self.host_backup:
            train_h = self._to_host("train")
            self._flush(in_place=True)
            val_idx, trans = self._phase("val", False, _copy_index(train_idx))
            val_h = self._to_host("val")
            self._from_host(train_h)
            _, induct = self._phase("nn_val", False, train_idx)
            self._from_host(val_h)
            self.index_state = val_idx
            return trans, induct
        train_mem = self.mem
        # the flush makes new tables: train_mem stays the unflushed backup
        self.mem = self._flush(in_place=False)
        val_idx, trans = self._phase("val", False, _copy_index(train_idx))
        val_mem = self.mem
        # the inductive leg consumes the train-end state; nothing reads it
        # afterwards
        self.mem = train_mem
        _, induct = self._phase("nn_val", False, train_idx)
        self.mem, self.index_state = val_mem, val_idx
        return trans, induct

    def test(self) -> Tuple[PhaseResult, PhaseResult]:
        """Transductive and inductive test, each from the val-end state.
        Leaves the test-end index and the inductive leg's memory, as the
        JAX Trainer does. Under ``host_backup`` the val-end tables wait in
        host memory during the transductive leg."""
        val_idx = self.index_state
        if self.host_backup:
            val_h = self._to_host("val")
            self.index_state, trans = self._phase("test", False,
                                                  _copy_index(val_idx))
            self._from_host(val_h)
            _, induct = self._phase("nn_test", False, val_idx)
            return trans, induct
        val_mem = self.mem
        self.mem = MemoryState(*(x.clone() for x in val_mem))
        self.index_state, trans = self._phase("test", False,
                                              _copy_index(val_idx))
        self.mem = val_mem
        _, induct = self._phase("nn_test", False, val_idx)
        return trans, induct

    # ---------------------------------------------------------------- state

    def _take_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a one-process table (all of them unless
        row-sharded), on its device."""
        if self.exchange is not None:
            t = take_rows(t, self.mesh.rank, self._rows).clone()
        return t.to(self.device)

    def _memory_from(self, tables: Dict[str, torch.Tensor]) -> MemoryState:
        """Memory tables as a state file holds them ([S, N, ...] for S
        seeds, of which this rank takes its lanes; [N, ...], of which a
        row-sharded rank takes its rows) → this Trainer's (flat) tables on
        its device."""
        n = self._n_seeds * self._rows
        if self._stacked:
            tables = {k: take_lanes(v, self._lanes) for k, v in tables.items()}
        return MemoryState(**{k: self._take_rows(v).reshape((n,) + v.shape[
            1 + self._stacked:]) for k, v in tables.items()})

    def _memory_tables(self, mem: Optional[MemoryState] = None
                       ) -> Dict[str, torch.Tensor]:
        """The memory tables as a state file holds them: [S, N, ...] for S
        seeds (views of the flat tables; this rank's lanes), [N, ...] for
        one."""
        mem = self.mem if mem is None else mem
        if not self._stacked:
            return mem._asdict()
        return {k: v.view((self._n_seeds, -1) + v.shape[1:])
                for k, v in mem._asdict().items()}

    def _gather(self, lanes: Dict) -> Optional[Dict]:
        """Per-rank blocks (each value, or each value of a dict value,
        holds this rank's lanes, or its node rows, on its leading axis) →
        every rank's, at rank 0 (None elsewhere), for a file in the
        one-process layout."""
        gather = lambda t: gather_blocks(self.mesh, t)
        out = {k: ({n: gather(v) for n, v in d.items()}
                   if isinstance(d, dict) else gather(d))
               for k, d in lanes.items()}
        return out if self.mesh.lead else None

    def gathered_state(self) -> Tuple[MemoryState, Optional[TpprState]]:
        """The memory tables and the index in the one-process layout on
        every rank, on its device: a collective where the rows are sharded
        (every rank calls it), this Trainer's own state elsewhere."""
        if self.exchange is None:
            return self.mem, self.index_state
        every = lambda t: all_gather_blocks(self.mesh, t)
        return (MemoryState(*(every(x) for x in self.mem)),
                None if self.index_state is None
                else TpprState(every(self.index_state.data)))

    def _save_best(self) -> None:
        """fit's best checkpoint, (params, memory in the one-process
        layout), written by rank 0."""
        tree = {"params": self.params.state_dict(),
                "mem": self._memory_tables()}
        if self.exchange is not None:
            tree["mem"] = self._gather(tree["mem"])
        if self.mesh.lead:
            save_checkpoint(self.checkpoint_path, tree)
        barrier(self.mesh)

    def save_state(self, path: str, epoch: int = 0,
                   chunk: Optional[int] = None) -> None:
        """Full-state checkpoint: params, Adam's state, memory, index (None
        where no T-PPR index is kept), the dropout generator's state, the
        negative base and epoch id, the epoch and the stream cursor
        (``chunk``, the next superchunk to run; the Trainer's own cursor by
        default), and fit's early-stop fields.
        Seed-parallel: params and Adam's moments with their [S] axis,
        memory [S, N, ...], the shared index, the dropout states [S, ·] and
        the negative bases [S]. A seed-sharded run writes the same file:
        rank 0 gathers every rank's lanes and writes it, as a one-process
        run of S seeds would, and the ranks wait for the write. A
        row-sharded run gathers the rows of the tables and the index to
        rank 0 the same way (the params, Adam's state and the dropout
        generator are the same on every rank).

        A mid-epoch cursor needs nothing more: this epoch's negatives are
        drawn again from (negative base, epoch id), and the dropout
        generator's state is the one the next superchunk starts from."""
        if chunk is None:
            chunk = self._chunk_cursor
        tree = {
            "cfg": dataclasses.asdict(self.cfg),
            "index_state": (None if self.index_state is None
                            else self.index_state.data),
            "epoch": int(epoch),
            "chunk": int(chunk),
            "epoch_id": self._epoch_id,
            "fit": self._fit_state,
        }
        if not self._stacked:
            rows = {"mem": self._memory_tables(), "index": tree["index_state"]}
            if self.exchange is not None:
                rows = self._gather({k: v for k, v in rows.items()
                                     if v is not None})
            if rows is not None:
                save_checkpoint(path, dict(
                    tree, params=self.params.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    mem=rows["mem"], index_state=rows.get("index"),
                    dropout=self._dropout.get_state(),
                    neg_base=self._neg_base))
            barrier(self.mesh)
            return
        opt = self.optimizer.state_dict()
        lanes = self._gather({
            "params": self.params.state_dict(),
            "mem": self._memory_tables(),
            "exp_avg": dict(enumerate(opt["exp_avg"])),
            "exp_avg_sq": dict(enumerate(opt["exp_avg_sq"])),
            "dropout": torch.stack([g.get_state() for g in self._dropout]),
            "neg_base": torch.from_numpy(np.asarray(self._neg_base,
                                                    np.int64)),
        })
        if lanes is not None:
            tree.update(
                params=lanes["params"], mem=lanes["mem"],
                optimizer=dict(opt, lrs=list(lane_lrs(self.cfg)),
                               exp_avg=list(lanes["exp_avg"].values()),
                               exp_avg_sq=list(lanes["exp_avg_sq"].values())),
                dropout=lanes["dropout"],
                neg_base=[int(b) for b in lanes["neg_base"]])
            save_checkpoint(path, tree)
        # the ranks go on once the file is whole
        barrier(self.mesh)

    def restore_state(self, path: str) -> Tuple[int, int]:
        """Restore a ``save_state`` file; returns (epoch, chunk). Pass
        ``chunk`` to ``train_epoch(start_chunk=...)`` to finish a partly
        trained epoch. Refuses a file whose state-shaping fields differ
        from this Trainer's (``Config.STATE_FIELDS``). A seed-sharded rank
        takes its lanes of the file, a row-sharded rank its rows, whatever
        number of ranks wrote it."""
        ckpt = load_checkpoint(path)
        diffs = Config.state_compat_diff(Config.from_dict(ckpt["cfg"]),
                                         self.cfg)
        if diffs:
            hint = ""
            if any(d.startswith("parallel_runs:") for d in diffs):
                hint = (" (to serve one seed of a seed-parallel checkpoint "
                        "use LinkPredictor.from_checkpoint(run_index=...))")
            raise ValueError(
                "checkpoint config is incompatible with this Trainer; "
                "restoring would mis-shape or silently mis-read the "
                "state:\n  " + "\n  ".join(diffs) + hint)
        # in place, so the optimizer's state keeps referring to the live
        # tensors
        if not self._stacked:
            self.params.load_state_dict(ckpt["params"])
            self.optimizer.load_state_dict(ckpt["optimizer"])
            self._dropout.set_state(ckpt["dropout"])
            self._neg_base = ckpt["neg_base"]
        else:
            lanes = self._lanes
            take = lambda t: take_lanes(t, lanes)
            opt = ckpt["optimizer"]
            self.params.load_state_dict(
                {k: take(v) for k, v in ckpt["params"].items()})
            self.optimizer.load_state_dict(dict(
                opt, lrs=take_lanes(list(opt["lrs"]), lanes),
                exp_avg=[take(x) for x in opt["exp_avg"]],
                exp_avg_sq=[take(x) for x in opt["exp_avg_sq"]]))
            for g, state in zip(self._dropout, take(ckpt["dropout"])):
                g.set_state(state.clone())
            self._neg_base = take_lanes(
                np.asarray(ckpt["neg_base"], np.int64), lanes)
        self.mem = self._memory_from(ckpt["mem"])
        self.index_state = (None if ckpt["index_state"] is None else
                            TpprState(self._take_rows(ckpt["index_state"])))
        self._chunk_cursor = ckpt["chunk"]
        self._epoch_id = ckpt["epoch_id"]
        self._fit_state = ckpt["fit"]
        return ckpt["epoch"], ckpt["chunk"]

    # ---------------------------------------------------------------- run

    def fit(self, n_epoch: Optional[int] = None,
            resume_from: Optional[str] = None) -> Dict[str, float]:
        """The run: epochs of ``train_epoch`` then ``validate`` with early
        stopping on the transductive val AP, then ``test``, with the JAX
        package's keys, log lines and order of operations. ``resume_from``
        restores a ``save_state`` file (``--state_every`` or a stop
        request) and continues from it: the early-stop monitor, and a
        mid-epoch cursor if one was saved. A seed-parallel Trainer runs
        :meth:`_fit_seeds`."""
        if self._stacked:
            return self._fit_seeds(n_epoch, resume_from)
        cfg = self.cfg
        n_epoch = n_epoch or cfg.n_epoch
        stopper = EarlyStopMonitor(max_round=cfg.patience)
        stop_epoch = -1
        timers = PhaseTimers()
        n_train_events = self.splits.train.n_interactions

        start_epoch, start_chunk = 0, 0
        if resume_from:
            start_epoch, start_chunk = self.restore_state(resume_from)
            for k, v in (self._fit_state or {}).items():
                setattr(stopper, k, v)
            logger.info("resumed from %s at epoch %d chunk %d",
                        resume_from, start_epoch, start_chunk)
        state_path = os.path.join(cfg.checkpoint_dir,
                                  cfg.run_name() + ".state.ckpt")

        for epoch in range(start_epoch, n_epoch):
            with trace_context(
                    cfg.trace_dir if epoch == cfg.trace_epoch else None):
                with timers.time("train", n_train_events):
                    # a restored mid-epoch cursor finishes its epoch first
                    tr = self.train_epoch(
                        start_chunk=start_chunk if epoch == start_epoch else 0)
            if self._agree_stop():
                self._fit_state = self._stopper_state(stopper)
                # train_epoch returns the cursor to 0 when the epoch ran to
                # its end: then the next epoch is where to resume
                done = self._chunk_cursor == 0
                self.save_state(state_path,
                                epoch=epoch + 1 if done else epoch,
                                chunk=self._chunk_cursor)
                self._fit_state = None
                logger.info(
                    "stop requested: resumable state saved to %s "
                    "(epoch %d, chunk %d)", state_path, epoch,
                    self._chunk_cursor)
                return {"interrupted": True, "state_path": state_path,
                        "stop_epoch": float(epoch)}
            timers.seconds["tppr"] += tr.index_seconds
            with timers.time("val"):
                trans, induct = self.validate()
            logger.info(
                "epoch: %d, tppr: %.2fs, train: %.2fs, val: %.2fs, "
                "train events/s: %.0f",
                epoch + 1, tr.index_seconds, tr.seconds,
                trans.seconds + induct.seconds,
                n_train_events / max(tr.seconds, 1e-9))
            logger.info(
                "train auc: %f, train ap: %f, train acc: %f, train loss: %f",
                tr.auc, tr.ap, tr.acc, tr.loss)
            logger.info("val auc: %f, new node val auc: %f", trans.auc,
                        induct.auc)
            logger.info("val ap: %f, new node val ap: %f", trans.ap, induct.ap)
            logger.info("val acc: %f, new node val acc: %f", trans.acc,
                        induct.acc)
            record = dict(epoch=epoch + 1, train_s=tr.seconds,
                          index_s=tr.index_seconds,
                          val_s=trans.seconds + induct.seconds,
                          train_events_per_s=n_train_events / max(
                              tr.seconds, 1e-9),
                          waves=tr.waves, train_ap=tr.ap, val_ap=trans.ap,
                          nn_val_ap=induct.ap, state_s=None)
            self.epoch_log.append(record)

            if stopper.early_stop_check(trans.ap):
                # the best epoch's params and memory; the index stays where
                # the last validate left it, as in the JAX package
                stop_epoch = epoch + 1
                best = load_checkpoint(self.checkpoint_path)
                self.params.load_state_dict(best["params"])
                self.mem = self._memory_from(best["mem"])
                break
            if epoch == stopper.best_epoch:
                self._save_best()
            if cfg.state_every and (epoch + 1) % cfg.state_every == 0:
                # an epoch boundary: the next epoch starts from zeroed
                # memory and an empty index
                t0 = time.perf_counter()
                self._fit_state = self._stopper_state(stopper)
                self.save_state(state_path, epoch=epoch + 1, chunk=0)
                self._fit_state = None
                record["state_s"] = time.perf_counter() - t0

        with timers.time("test"):
            t_trans, t_induct = self.test()
        logger.info("phase totals: %s", timers.summary())
        logger.info("Test statistics: Old nodes -- auc: %f, ap: %f, acc: %f",
                    t_trans.auc, t_trans.ap, t_trans.acc)
        logger.info("Test statistics: New nodes -- auc: %f, ap: %f, acc: %f",
                    t_induct.auc, t_induct.ap, t_induct.acc)
        if (self.mesh.lead and not cfg.save_best
                and os.path.exists(self.checkpoint_path)):
            os.remove(self.checkpoint_path)
        return {
            "test_ap": t_trans.ap,
            "test_auc": t_trans.auc,
            "test_acc": t_trans.acc,
            "nn_test_ap": t_induct.ap,
            "nn_test_auc": t_induct.auc,
            "nn_test_acc": t_induct.acc,
            "stop_epoch": float(stop_epoch),
        }

    # ---------------------------------------------------------------- seeds

    @classmethod
    def _seed_stopper_state(cls, stoppers, stopped, stop_epoch) -> Dict:
        return {"per_seed": [
            dict(cls._stopper_state(st), stopped=stopped[s],
                 stop_epoch=stop_epoch[s])
            for s, st in enumerate(stoppers)]}

    def _lane_snapshot(self, s: int):
        """Copies of local lane ``s``'s (params, memory tables)."""
        n = self.cfg.n_nodes
        rows = slice(s * n, (s + 1) * n)
        return ({k: v[s].detach().clone()
                 for k, v in self.params.state_dict().items()},
                MemoryState(*(x[rows].clone() for x in self.mem)))

    def _stack_snapshots(self, snaps):
        """Per-seed (params, memory) snapshots → the stacked (params state,
        [S, N, ...] tables) a best checkpoint holds."""
        params = {k: torch.stack([p[k] for p, _ in snaps])
                  for k in snaps[0][0]}
        mem = {f: torch.stack([m[i] for _, m in snaps])
               for i, f in enumerate(MemoryState._fields)}
        return params, mem

    def _fit_seeds(self, n_epoch: Optional[int] = None,
                   resume_from: Optional[str] = None) -> Dict:
        """Seed-parallel fit (``zebra_tpu/train/loop.py:_fit_seeds``): one
        epoch loop with early stopping per seed. Each seed keeps its own
        stopper and best-epoch (params, memory) snapshot; a stopped seed
        keeps riding the batched phases (its snapshot is what test uses),
        so the run lasts as long as its latest-stopping seed. Test runs
        every seed in one pass: stopped seeds from their best snapshot,
        the others from their final state. Returns the mean and σ per
        metric and the per-seed values with each seed's lr.

        Seed-sharded, every rank runs all S stoppers on the gathered
        metrics, so every rank decides alike at the same epoch; a rank
        keeps the snapshots of its own lanes, and the best checkpoint
        gathers them."""
        cfg = self.cfg
        s_n = cfg.n_seeds
        lanes = self._lanes
        n_epoch = n_epoch or cfg.n_epoch
        stoppers = [EarlyStopMonitor(max_round=cfg.patience)
                    for _ in range(s_n)]
        stopped, stop_epoch = [False] * s_n, [-1] * s_n
        # global lane → this rank's (params, memory) snapshot of it
        best: Dict[int, Tuple] = {}
        timers = PhaseTimers()
        n_train_events = self.splits.train.n_interactions

        start_epoch, start_chunk = 0, 0
        if resume_from:
            start_epoch, start_chunk = self.restore_state(resume_from)
            for s, fields in enumerate(
                    (self._fit_state or {}).get("per_seed", [])[:s_n]):
                fields = dict(fields)
                stopped[s] = bool(fields.pop("stopped", False))
                stop_epoch[s] = int(fields.pop("stop_epoch", -1))
                for k, v in fields.items():
                    setattr(stoppers[s], k, v)
            if os.path.exists(self.checkpoint_path):
                ckpt = load_checkpoint(self.checkpoint_path)
                mem = self._memory_from(ckpt["mem"])
                n = cfg.n_nodes
                best = {g: ({k: v[g].to(self.device)
                             for k, v in ckpt["params"].items()},
                            MemoryState(*(x[i * n: (i + 1) * n]
                                          for x in mem)))
                        for i, g in enumerate(lanes)}
            logger.info("resumed seed-parallel fit from %s at epoch %d "
                        "chunk %d", resume_from, start_epoch, start_chunk)
        state_path = os.path.join(cfg.checkpoint_dir,
                                  cfg.run_name() + ".state.ckpt")

        def save_best():
            """The stacked best-or-current (params, memory) of every seed."""
            params, mem = self._stack_snapshots(
                [best[g] if g in best else self._lane_snapshot(i)
                 for i, g in enumerate(lanes)])
            tree = self._gather({"params": params, "mem": mem})
            if tree is not None:
                save_checkpoint(self.checkpoint_path, tree)
            barrier(self.mesh)

        for epoch in range(start_epoch, n_epoch):
            with trace_context(
                    cfg.trace_dir if epoch == cfg.trace_epoch else None):
                with timers.time("train", n_train_events):
                    tr = self.train_epoch(
                        start_chunk=start_chunk if epoch == start_epoch else 0)
            if self._agree_stop():
                self._fit_state = self._seed_stopper_state(
                    stoppers, stopped, stop_epoch)
                done = self._chunk_cursor == 0
                self.save_state(state_path,
                                epoch=epoch + 1 if done else epoch,
                                chunk=self._chunk_cursor)
                self._fit_state = None
                save_best()
                logger.info(
                    "stop requested: resumable seed-parallel state saved to "
                    "%s (epoch %d, chunk %d)", state_path, epoch,
                    self._chunk_cursor)
                return {"interrupted": True, "state_path": state_path,
                        "stop_epoch": float(epoch)}
            timers.seconds["tppr"] += tr.index_seconds
            with timers.time("val"):
                trans, induct = self.validate()
            live = sum(not x for x in stopped)
            logger.info(
                "epoch: %d (%d seeds, %d live), tppr: %.2fs, train: %.2fs, "
                "val: %.2fs, train events/s (aggregate): %.0f",
                epoch + 1, s_n, live, tr.index_seconds, tr.seconds,
                trans.seconds + induct.seconds,
                s_n * n_train_events / max(tr.seconds, 1e-9))
            logger.info("train ap: %s, train loss: %s", _fmt_seeds(tr.ap),
                        _fmt_seeds(tr.loss))
            logger.info("val ap: %s, new node val ap: %s",
                        _fmt_seeds(trans.ap), _fmt_seeds(induct.ap))
            self.epoch_log.append(dict(
                epoch=epoch + 1, train_s=tr.seconds, index_s=tr.index_seconds,
                val_s=trans.seconds + induct.seconds,
                train_events_per_s=s_n * n_train_events / max(
                    tr.seconds, 1e-9),
                waves=tr.waves, train_ap=tr.ap.tolist(),
                val_ap=trans.ap.tolist(), nn_val_ap=induct.ap.tolist(),
                live_seeds=live, state_s=None))

            improved = False
            for s in range(s_n):
                if stopped[s]:
                    continue
                if stoppers[s].early_stop_check(float(trans.ap[s])):
                    stopped[s] = True
                    stop_epoch[s] = epoch + 1
                    logger.info("seed %d stopped at epoch %d (best epoch %d)",
                                s, epoch + 1, stoppers[s].best_epoch + 1)
                elif epoch == stoppers[s].best_epoch:
                    if s in lanes:
                        best[s] = self._lane_snapshot(s - lanes.start)
                    improved = True
            if improved:
                save_best()
            if all(stopped):
                break
            if cfg.state_every and (epoch + 1) % cfg.state_every == 0:
                t0 = time.perf_counter()
                self._fit_state = self._seed_stopper_state(
                    stoppers, stopped, stop_epoch)
                self.save_state(state_path, epoch=epoch + 1, chunk=0)
                self._fit_state = None
                self.epoch_log[-1]["state_s"] = time.perf_counter() - t0

        # the test protocol: stopped seeds from their best snapshot, the
        # others from their final state
        n = cfg.n_nodes
        with torch.no_grad():
            for i, g in enumerate(lanes):
                if stopped[g] and g in best:
                    params, mem = best[g]
                    for k, v in self.params.state_dict().items():
                        v[i].copy_(params[k])
                    for x, y in zip(self.mem, mem):
                        x[i * n: (i + 1) * n] = y

        with timers.time("test"):
            t_trans, t_induct = self.test()
        logger.info("phase totals: %s", timers.summary())
        logger.info("Test statistics: Old nodes -- ap: %s, auc: %s, acc: %s",
                    _fmt_seeds(t_trans.ap), _fmt_seeds(t_trans.auc),
                    _fmt_seeds(t_trans.acc))
        logger.info("Test statistics: New nodes -- ap: %s, auc: %s, acc: %s",
                    _fmt_seeds(t_induct.ap), _fmt_seeds(t_induct.auc),
                    _fmt_seeds(t_induct.acc))
        if (self.mesh.lead and not cfg.save_best
                and os.path.exists(self.checkpoint_path)):
            os.remove(self.checkpoint_path)

        mean = lambda x: float(np.asarray(x).mean())
        std = lambda x: float(np.asarray(x).std())
        aslist = lambda x: [float(v) for v in np.asarray(x)]
        return {
            "test_ap": mean(t_trans.ap), "test_ap_std": std(t_trans.ap),
            "test_auc": mean(t_trans.auc), "test_acc": mean(t_trans.acc),
            "nn_test_ap": mean(t_induct.ap),
            "nn_test_ap_std": std(t_induct.ap),
            "nn_test_auc": mean(t_induct.auc),
            "nn_test_acc": mean(t_induct.acc),
            "stop_epoch": float(np.mean(stop_epoch)),
            "per_seed": {
                "test_ap": aslist(t_trans.ap),
                "test_auc": aslist(t_trans.auc),
                "test_acc": aslist(t_trans.acc),
                "nn_test_ap": aslist(t_induct.ap),
                "nn_test_auc": aslist(t_induct.auc),
                "nn_test_acc": aslist(t_induct.acc),
                "stop_epoch": [float(e) for e in stop_epoch],
                "lr": [float(lr) for lr in lane_lrs(cfg)],
            },
        }


def _copy_index(index_state: Optional[TpprState]) -> Optional[TpprState]:
    """A copy of the index state (None, where no T-PPR index is kept,
    stays None)."""
    return None if index_state is None else TpprState(index_state.data.clone())


def _fmt_seeds(x) -> str:
    """Log format for a per-seed metric vector: mean±σ plus the values."""
    a = np.asarray(x, np.float64).ravel()
    vals = ", ".join(f"{v:.6f}" for v in a)
    return f"{a.mean():.6f}±{a.std():.6f} [{vals}]"
