"""CUDA graphs of the full streaming train batch, and of serving's eval
memory protocol (:class:`ProtocolGraphs`, at the end).

A full train batch of the streaming diffusion path has static shapes and
reads nothing back (``train/step.py``: a full batch passes no mask, so no
``nonzero``), so it enqueues the same fixed sequence of a few hundred
small operations every time, and the host's enqueue, not the card, sets
its pace. Here its parts are captured once as four CUDA graphs that share
one memory pool, and each later full batch replays them:

- forward: the queries from the batch's extraction rows, the towers, the
  scores and the loss;
- backward: the loss's backward, which writes the parameters' gradients
  into tensors the graph owns;
- protocol: the memory protocol, commit then store;
- metrics: the batch's row of :data:`~zebra_tpu_torch.train.phase.METRICS`.

The part functions are the ones ``train/phase.py``'s eager batch calls,
captured as they run; :meth:`BatchGraphs.bind` hands back the same parts
as replays, and the batch runs them in the same order under the same
spans. Adam's step stays an eager call between the backward and the
protocol replays, so it reads the gradients the backward graph wrote and
anything wrapping ``optimizer.step`` sees every step. The dropout
generators are registered with the forward graph, so a replay draws the
masks an eager batch draws and advances each generator as far.

A graph keeps the addresses it was captured with: the parameters, the
memory tables, the edge features, the lane offsets and the generators.
:meth:`BatchGraphs.bind` replays only while the caller passes those very
objects and the batch shape is the captured one, and captures anew
otherwise (``Trainer.set_params``, a restored state file); the Trainer's
epoch reset zeroes the captured tables in place (:meth:`tables`), so a
new epoch keeps its graphs. Capture starts with one eager batch on the
capture stream (lazy library set-up must not fall inside a capture), and
puts the memory tables and the generators back as they were after it."""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.train.step import eval_protocol
from zebra_tpu_torch.utils.profiling import CAPTURE, span


def replays(cfg: Config, train: bool, device: torch.device, queries,
            full: bool) -> bool:
    """Whether a batch runs from the graphs: a full (``full``, no padding)
    train batch on a CUDA ``device`` whose ``queries`` are a superchunk's
    extraction-row tensor (the streaming diffusion path; the BFS's index
    or None for the other towers is not), on a path that is not
    row-sharded (``cfg.n_devices`` > 1 with one seed) and without
    ``cfg.debug_nans``'s per-batch host read. Every other batch runs
    eagerly."""
    row_sharded = cfg.n_devices > 1 and cfg.n_seeds == 1
    return (device.type == "cuda" and train and full
            and isinstance(queries, torch.Tensor) and not row_sharded
            and not cfg.debug_nans)


class Parts(NamedTuple):
    """The parts of a train batch as functions of its inputs: ``forward``
    (batch columns, extraction rows) → its outputs, with ``loss`` and
    ``plan`` (the lazy plan, or None) among their fields; ``backward``
    (outputs) and ``protocol`` (columns, outputs, valid mask or None for
    a full batch) → None; ``metrics`` (columns, outputs) → the batch's
    metrics row."""

    forward: Callable
    backward: Callable
    protocol: Callable
    metrics: Callable


class Bound(NamedTuple):
    """The model state a phase's batches (or serving's protocol: no
    generator) read and write, and so what a capture is bound to: the
    objects whose storage its graphs read or write."""

    cfg: Config
    params: torch.nn.Module
    mem: MemoryState
    edge_feats: torch.Tensor
    generator: object           # a generator, or a list of one per lane
    offs: Optional[torch.Tensor]


class _Capture(NamedTuple):
    bound: Bound
    shapes: Tuple
    parts: Parts                # kept: its closures hold what the graphs
                                # read (a phase's lane blocks, say)
    batch: tuple                # the static batch columns (a Stream)
    rows: torch.Tensor          # the static extraction rows
    out: tuple                  # the forward's static outputs
    row: torch.Tensor           # the metrics graph's static row
    grads: List[Tuple[torch.Tensor, torch.Tensor]]  # (param, static grad)
    graphs: Tuple[torch.cuda.CUDAGraph, ...]  # forward, backward,
                                              # protocol, metrics


def _detached(x):
    """``x`` (a tensor, a NamedTuple of them or None) without autograd
    history, on the same storage."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, tuple):
        return type(x)(*(_detached(v) for v in x))
    return x


def _generators(generator) -> list:
    return list(generator) if isinstance(generator, (list, tuple)) else [
        generator]


class BatchGraphs:
    """The captured graphs of one Trainer's full train batches, and how
    often they ran: ``captures`` (each captures all four parts),
    ``replays`` (batches replayed) and ``eager`` (train batches that ran
    eagerly)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self._c: Optional[_Capture] = None
        self._replayed: Optional[Parts] = None

    def tables(self) -> Optional[MemoryState]:
        """The memory tables the graphs are bound to (None before a
        capture)."""
        return None if self._c is None else self._c.bound.mem

    def bind(self, bound: Bound, parts: Parts, batch: tuple,
             rows: torch.Tensor) -> Parts:
        """This batch's ``parts`` as replays of their graphs on the state
        ``bound`` names (:func:`_replayed`), captured first (warmed up on
        ``batch`` and ``rows``) unless the ones held were captured on the
        same objects; the parameters' ``.grad`` set to the backward
        graph's gradients (an eager batch drops them). Counts the batch
        as replayed."""
        c = self._c
        shapes = (tuple(rows.shape),) + tuple(tuple(x.shape) for x in batch)
        if c is None or shapes != c.shapes or not _same(c.bound, bound):
            # free the old graphs and their pool first
            self._c = self._replayed = None
            with span(CAPTURE):
                c = self._c = _capture(bound, shapes, parts, batch, rows)
            self._replayed = _replayed(c)
            self.captures += 1
        for p, g in c.grads:
            if p.grad is not g:
                p.grad = g
        self.replays += 1
        return self._replayed


def _same(a: Bound, b: Bound) -> bool:
    return (a.params is b.params and a.mem is b.mem
            and a.edge_feats is b.edge_feats and a.generator is b.generator
            and a.offs is b.offs and (a.cfg is b.cfg or a.cfg == b.cfg))


def _replayed(c: _Capture) -> Parts:
    """The parts of ``c`` as replays of its graphs: ``forward`` copies the
    batch's columns and extraction rows into the static inputs first;
    ``metrics`` returns a copy of the row, which the next replay
    overwrites. The forward's outputs are the static ones, save the lazy
    plan's overflow flag, which the caller keeps past the batch: copied
    where the graph writes it (the compaction's; per position it is a
    constant 0)."""
    graphs = c.graphs

    def forward(batch, rows):
        for dst, src in zip(c.batch, batch):
            dst.copy_(src)
        c.rows.copy_(rows)
        graphs[0].replay()
        plan = c.out.plan
        if plan is None or plan.uniq is None:
            return c.out
        return c.out._replace(plan=plan._replace(
            overflow=plan.overflow.clone()))

    def metrics(batch, out):
        graphs[3].replay()
        return c.row.clone()

    return Parts(forward, lambda out: graphs[1].replay(),
                 lambda batch, out, valid: graphs[2].replay(), metrics)


def _capture(bound: Bound, shapes, parts: Parts, batch: tuple,
             rows: torch.Tensor) -> _Capture:
    """One eager batch on the capture stream, the memory tables and the
    generators put back, then the four parts captured in order into one
    pool (they replay in that order, so one part's scratch may reuse
    another's)."""
    gens = _generators(bound.generator)
    params = list(bound.params.parameters())
    batch = type(batch)(*(x.clone() for x in batch))
    rows = rows.clone()
    saved = [x.clone() for x in bound.mem]
    states = [g.get_state() for g in gens]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = parts.forward(batch, rows)
        parts.backward(out)
        parts.protocol(batch, out, None)
        parts.metrics(batch, out)
    torch.cuda.current_stream().wait_stream(side)
    for x, y in zip(bound.mem, saved):
        x.copy_(y)
    for g, state in zip(gens, states):
        g.set_state(state)
    del out, saved
    for p in params:
        p.grad = None
    graphs = tuple(torch.cuda.CUDAGraph() for _ in range(4))
    for g in gens:
        graphs[0].register_generator_state(g)
    pool = torch.cuda.graph_pool_handle()
    with torch.cuda.graph(graphs[0], pool=pool, stream=side):
        out = parts.forward(batch, rows)
    with torch.cuda.graph(graphs[1], pool=pool, stream=side):
        parts.backward(out)
    # the autograd graph is spent: its nodes, kept alive by the outputs,
    # would tie the parameters' gradient accumulators to this stream
    out = _detached(out)
    with torch.cuda.graph(graphs[2], pool=pool, stream=side):
        parts.protocol(batch, out, None)
    with torch.cuda.graph(graphs[3], pool=pool, stream=side):
        row = parts.metrics(batch, out)
    return _Capture(bound, shapes, parts, batch, rows, out, row,
                    [(p, p.grad) for p in params if p.grad is not None],
                    graphs)


# ------------------------------------------------------------ serving

def protocol_replays(cfg: Config, device: torch.device) -> bool:
    """Whether ``LinkPredictor.observe``'s eval protocol may run from a
    graph: on a CUDA ``device``, and without a message-source flag
    (``cfg.need_emb``), whose eval forward inside the protocol a recursive
    tower would run over an adjacency index that every fold replaces.
    Both aggregators replay (``mean``'s sort-based ``index_put_``
    accumulates as it does eagerly)."""
    return device.type == "cuda" and not cfg.need_emb


LENGTHS = 4   # call lengths whose protocol graphs a predictor holds


class _Protocol(NamedTuple):
    cols: Tuple[torch.Tensor, ...]   # the static src, dst, t, eidx
    graph: torch.cuda.CUDAGraph


class ProtocolGraphs:
    """Serving's eval memory protocol, ``eval_protocol`` with no mask (every
    observed event is valid, so nothing is read back), as one CUDA graph
    per call length, for at most :data:`LENGTHS` lengths (a steady step's
    and a stream's shorter tail, say); a call of another length runs
    eagerly.

    :meth:`run` replays while the caller passes the objects the graphs
    were captured on (:class:`Bound`: the parameters, the memory tables,
    the edge features and the lane offsets) and drops them all otherwise.
    The first call of a length runs its protocol eagerly on the capture
    stream, which warms it up and does the call's work, then captures it
    (a capture runs nothing, so no table is copied aside). All lengths
    share one capture stream, and so its cuBLAS workspace. Counts each
    call once: ``captures``, ``replays`` or ``eager``."""

    def __init__(self):
        self.lengths = LENGTHS
        self.captures = self.replays = self.eager = 0
        self._bound: Optional[Bound] = None
        self._held: dict = {}    # call length -> _Protocol
        self._stream: Optional[torch.cuda.Stream] = None

    def run(self, bound: Bound, cols: Tuple[torch.Tensor, ...]) -> bool:
        """The protocol of the call's columns ``cols`` (src, dst, t, eidx)
        on ``bound``'s tables, in place, replayed or captured: True; False
        (counted as eager) where the caller runs it itself, as
        :func:`protocol_replays` or the length cap decides."""
        if not protocol_replays(bound.cfg, bound.edge_feats.device):
            self.eager += 1
            return False
        if self._bound is None or not _same(self._bound, bound):
            self._bound, self._held = bound, {}
        n = cols[0].shape[0]
        held = self._held.get(n)
        if held is None:
            if len(self._held) >= self.lengths:
                self.eager += 1
                return False
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            with span(CAPTURE):
                self._held[n] = _capture_protocol(bound, cols, self._stream)
            self.captures += 1
            return True
        for dst, src in zip(held.cols, cols):
            dst.copy_(src)
        held.graph.replay()
        self.replays += 1
        return True


def _capture_protocol(bound: Bound, cols, side) -> _Protocol:
    """The call's protocol run eagerly on the capture stream ``side``, then
    captured on static copies of its columns into a private pool."""
    cols = tuple(c.clone() for c in cols)

    def protocol():
        eval_protocol(bound.cfg, bound.params, bound.mem, bound.edge_feats,
                      *cols, None, bound.offs)

    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        protocol()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        protocol()
    return _Protocol(cols, graph)
