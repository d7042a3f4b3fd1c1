"""The trainer for one seed on one device (counterpart of
``zebra_tpu/train/loop.py``): ``Trainer(cfg, splits, edge_feats)``, then
``train_epoch()``, ``validate()`` and ``test()``.

Per epoch: zeroed memory and an empty index, then the train stream in
superchunks. For each superchunk the host schedules the waves of the index
scan (this epoch's negatives included, as their rows are read), the device
runs the wave scan (``index/waves.py``: one ``santa_merge`` launch per wave
on the card), which extracts every event's T-PPR queries before its
update, and ``run_phase`` trains over the chunk's batches with them. The
index state at the end of the train stream is the state validation starts
from.

validate: flush pending messages (the train→eval transition), run the
transductive val stream from (train-end memory, train-end index), keep that
val-end state, run the inductive val stream from the unflushed train-end
state, then restore the val-end state. test: the transductive and the
inductive test streams, each from the val-end state.

Negatives are drawn on the host: eval negatives once, from samplers seeded
0/2/3 (the inductive val stream reuses the val sampler); train negatives
every epoch from (base, epoch). The same inputs and seed give the JAX
Trainer's negatives. The Trainer runs on CUDA unless ``device="cpu"`` is
passed."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from zebra_tpu_torch.config import Config, torch_dtype
from zebra_tpu_torch.data.dataset import Data, DatasetSplits
from zebra_tpu_torch.data.sampler import RandEdgeSampler
from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    TpprState,
    check_id_width,
    init_tppr_state,
)
from zebra_tpu_torch.index.waves import WavePlan, plan_waves, wave_scan_chunk
from zebra_tpu_torch.models.memory import MemoryState, init_memory
from zebra_tpu_torch.models.tgn import init_tgn_params
from zebra_tpu_torch.train.phase import Stream, _mark, run_phase
from zebra_tpu_torch.train.step import flush_pending, make_optimizer

# eval negative-sampling seeds; the inductive val stream shares the val
# sampler
SEED_VAL, SEED_TEST, SEED_NN_TEST = 0, 2, 3


@dataclass
class PhaseResult:
    ap: float
    auc: float
    acc: float
    loss: float = 0.0
    seconds: float = 0.0
    index_seconds: float = 0.0   # host clock in the index: scheduling and
                                 # enqueueing the waves (the device runs
                                 # them behind the host)
    waves: int = 0               # index waves run: one santa_merge launch
                                 # each on the card
    per_batch: Optional[np.ndarray] = field(  # [real batches, 4]: loss,
        default=None, repr=False)             # ap, auc, acc per batch


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
                 edge_feats: Optional[np.ndarray] = None, device=None):
        self.device = dev = resolve_device(device)
        # ids are 1-based with 0 as padding; N rounds up to a multiple of 128
        # (the JAX package's row-sharding alignment, kept so both packages
        # hold tables of one shape)
        n_nodes = -(-(splits.n_nodes + 1) // 128) * 128
        cfg = cfg.replace(n_nodes=n_nodes, n_edges=splits.n_edges + 1)
        if edge_feats is None:
            edge_feats = np.zeros((cfg.n_edges, 1), np.float32)
        cfg = cfg.replace(edge_dim=int(edge_feats.shape[1]))
        check_id_width(cfg.n_nodes, cfg.n_edges)
        self.cfg, self.splits = cfg, splits
        self.edge_feats = torch.as_tensor(
            np.asarray(edge_feats, np.float32)).to(dev)

        tr, fu = splits.train, splits.full
        self.train_sampler = RandEdgeSampler(tr.sources, tr.destinations)
        self.val_sampler = RandEdgeSampler(fu.sources, fu.destinations,
                                           seed=SEED_VAL)
        self.test_sampler = RandEdgeSampler(fu.sources, fu.destinations,
                                            seed=SEED_TEST)
        self.nn_test_sampler = RandEdgeSampler(
            splits.new_node_test.sources, splits.new_node_test.destinations,
            seed=SEED_NN_TEST)
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
        # eval negatives are fixed, so their wave plans are made once
        self._eval_plans: Dict[str, List[WavePlan]] = {}
        self._tppr = TpprParams.create(cfg.alpha_list, cfg.beta_list,
                                       cfg.topk)

        # the base of the per-epoch train negatives: the first draw of a
        # RandomState seeded with cfg.seed (random under enable_random)
        draw = np.random if cfg.enable_random else np.random.RandomState(
            cfg.seed)
        self._neg_base = int(draw.randint(0, 2**31 - 1))
        self._epoch_id = 0

        self.set_params(init_tgn_params(
            cfg, torch.Generator().manual_seed(cfg.seed), dev))
        # dropout masks; JAX's rbg masks cannot be reproduced
        self._dropout = torch.Generator(dev).manual_seed(cfg.seed)
        self.mem, self.index_state = self._fresh_state()

    def set_params(self, params) -> None:
        """Train ``params`` (an ``nn.ModuleDict`` on this Trainer's device)
        from here on, with a fresh Adam state."""
        self.params = params.to(self.device).requires_grad_(True)
        self.optimizer = make_optimizer(self.cfg, self.params)

    # ---------------------------------------------------------------- helpers

    def _fresh_state(self) -> Tuple[MemoryState, TpprState]:
        cfg = self.cfg
        mem = init_memory(cfg.n_nodes, cfg.memory_dim, cfg.msg_table_dim,
                          torch_dtype(cfg.message_dtype),
                          torch_dtype(cfg.memory_dtype), device=self.device)
        return mem, init_tppr_state(cfg.n_tppr, cfg.n_nodes, cfg.topk,
                                    device=self.device)

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

        negs = (sampler.sample_eval_negatives(n, bs)
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
        draw from a RandomState seeded with (base, epoch)."""
        n = self.splits.train.n_interactions
        pad = len(self._streams["train"].host["src"]) - n
        rs = np.random.RandomState(
            (self._neg_base + 0x9E3779B1 * (epoch_id + 1)) % (2**32))
        _, negs = self.train_sampler.sample_with(rs, n)
        return np.concatenate([negs, np.zeros(pad, negs.dtype)]).astype(
            np.int32)

    def _wave_plans(self, name: str, negs: np.ndarray) -> List[WavePlan]:
        """The wave plan of every superchunk of stream ``name`` under the
        negatives ``negs`` (host scheduling, then one upload per chunk)."""
        ps = self._streams[name]
        host = ps.host
        total = len(host["src"])
        chunk = total // ps.n_chunks
        return [
            plan_waves(host["src"][lo: lo + chunk], host["dst"][lo: lo + chunk],
                       negs[lo: lo + chunk], host["valid"][lo: lo + chunk],
                       self.cfg.n_nodes, self.cfg.wave_cap, self.device)
            for lo in range(0, total, chunk)
        ]

    def _phase(self, name: str, train: bool, index_state: TpprState,
               marks: Optional[list] = None) -> Tuple[TpprState, PhaseResult]:
        """One pass over stream ``name``: per superchunk, the wave scan of
        the index, then the batches. Updates ``self.mem``, ``index_state``
        and, in training, the parameters in place; reads the metrics back
        once, at the end."""
        t0 = time.perf_counter()
        cfg = self.cfg
        ps = self._streams[name]
        stream = ps.stream
        if train:
            negs = self._draw_train_negs(self._epoch_id)
            stream = stream._replace(neg=torch.from_numpy(negs).to(self.device))
            plans = self._wave_plans(name, negs)
        else:
            if name not in self._eval_plans:
                self._eval_plans[name] = self._wave_plans(name, ps.host["neg"])
            plans = self._eval_plans[name]
        t_index = time.perf_counter() - t0

        total = stream.src.shape[0]
        chunk = total // ps.n_chunks
        per_chunk = chunk // cfg.bs
        n_valid = ps.n_valid()
        metrics = []
        _mark(marks, "start")
        for ci, lo in enumerate(range(0, total, chunk)):
            cs = Stream(*(x[lo: lo + chunk] for x in stream))
            ti = time.perf_counter()
            index_state, rows = wave_scan_chunk(index_state, self._tppr, *cs,
                                                plans[ci])
            t_index += time.perf_counter() - ti
            _mark(marks, "index")
            metrics.append(run_phase(
                cfg, train, self.params, self.optimizer, self.mem,
                self.edge_feats, cs, rows,
                n_valid[ci * per_chunk: (ci + 1) * per_chunk].tolist(),
                self._dropout if train else None, marks))
        per_batch = torch.cat(metrics).cpu().numpy()[: ps.real_batches]
        mean = per_batch.mean(axis=0)
        return index_state, PhaseResult(
            loss=float(mean[0]), ap=float(mean[1]), auc=float(mean[2]),
            acc=float(mean[3]), seconds=time.perf_counter() - t0,
            index_seconds=t_index, waves=sum(p.n_waves for p in plans),
            per_batch=per_batch)

    # ---------------------------------------------------------------- epochs

    def train_epoch(self, marks: Optional[list] = None) -> PhaseResult:
        """One training epoch from zeroed memory and an empty index.
        ``marks``, a list (CUDA only), collects (part, CUDA event) pairs
        that time the epoch's parts on the device: "start", then "index"
        after each superchunk's wave scan, then ``run_phase``'s per-batch
        parts."""
        self.mem, self.index_state = self._fresh_state()
        self.index_state, result = self._phase("train", True,
                                               self.index_state, marks)
        self._epoch_id += 1
        return result

    def validate(self) -> Tuple[PhaseResult, PhaseResult]:
        """Transductive and inductive validation with the backup/restore
        protocol; leaves (mem, index) at the val-end state, where test()
        starts."""
        train_mem, train_idx = self.mem, self.index_state
        # the flush makes new tables: train_mem stays the unflushed backup
        self.mem = flush_pending(self.cfg, self.params, train_mem)
        val_idx, trans = self._phase("val", False,
                                     TpprState(train_idx.data.clone()))
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
        JAX Trainer does."""
        val_mem, val_idx = self.mem, self.index_state
        self.mem = MemoryState(*(x.clone() for x in val_mem))
        self.index_state, trans = self._phase(
            "test", False, TpprState(val_idx.data.clone()))
        self.mem = val_mem
        _, induct = self._phase("nn_test", False, val_idx)
        return trans, induct
