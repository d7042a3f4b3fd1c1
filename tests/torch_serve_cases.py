"""Small serving predictors of the port, on any device, and the check of
the unmasked eval protocol against an all-ones mask, for the tests of
observe's memory protocol: ``test_torch_serve_protocol.py`` on the CPU and
``test_torch_serve_graphs_card.py`` on the card. Imports no JAX (the
card's machine holds none). The tests import it by its bare name, from
the directory pytest puts on the path (a ``tests`` package installed
elsewhere may shadow this one's).

A case names a predictor: ``streaming`` (the diffusion tower over the
streaming T-PPR index), ``pruning`` (its BFS over the adjacency index,
folded at every observe) or ``ensemble`` (three seeds of ``streaming``,
an ``EnsemblePredictor``); keyword options replace config fields (the
aggregator, a message-source flag)."""

from typing import Tuple

import numpy as np
import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.index.streaming import init_tppr_state
from zebra_tpu_torch.models.memory import MemoryState, init_memory
from zebra_tpu_torch.models.tgn import init_seed_params, init_tgn_params
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor
from zebra_tpu_torch.train.step import eval_protocol

USERS, ITEMS, SEEDS = 300, 300, 3


def stream(n_events: int, seed: int = 3):
    """(cols, edge features): the (src, dst, t f32, eidx) numpy columns of
    a synthetic stream and its feature matrix."""
    data, ef = synthetic_stream(n_events, USERS, ITEMS, edge_dim=16,
                                seed=seed)
    return (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs), ef


def config(kind: str, n_events: int, **options) -> Config:
    """The case's config over ``stream(n_events)``'s node and edge ids."""
    if kind == "pruning":
        options = dict(tppr_strategy="pruning", n_degree=4, n_layer=2,
                       **options)
    return Config(node_dim=32, time_dim=32, memory_dim=32, topk=10,
                  alpha_list=(0.1, 0.1), beta_list=(0.5, 0.95),
                  n_nodes=USERS + ITEMS + 1, n_edges=n_events + 1,
                  edge_dim=16, seed=7, **options)


def predictor(kind: str, device, n_events: int,
              **options) -> Tuple[LinkPredictor, tuple]:
    """(a predictor of the case on ``device`` with random weights, bf16
    tables that are empty and an empty index, the stream's columns)."""
    cols, ef = stream(n_events)
    cfg = config(kind, n_events, **options)
    tables = lambda: init_memory(cfg.n_nodes, cfg.memory_dim,
                                 cfg.msg_table_dim, torch.bfloat16,
                                 torch.bfloat16, device="cpu")
    index = init_tppr_state(cfg.n_tppr, cfg.n_nodes, cfg.topk, device="cpu")
    if kind == "ensemble":
        params = init_seed_params(cfg.replace(parallel_runs=SEEDS), "cpu")
        mem = MemoryState(*(torch.stack([x] * SEEDS) for x in tables()))
        return EnsemblePredictor(cfg, params, mem, index, ef,
                                 device=device), cols
    params = init_tgn_params(cfg, torch.Generator().manual_seed(cfg.seed),
                             "cpu")
    if kind == "pruning":
        none = np.zeros(0, np.int64)
        empty = (none, none, np.zeros(0, np.float64), none)
        return LinkPredictor(
            cfg, params, tables(), None, ef,
            nbr_index=build_neighbor_index(*empty, cfg.n_nodes, "cpu"),
            events=empty, device=device), cols
    return LinkPredictor(cfg, params, tables(), index, ef,
                         device=device), cols


def pending_tables(cfg: Config, seeds: int = 1, seed: int = 0) -> MemoryState:
    """bf16 tables of ``seeds`` lanes, flat, with random rows, times and
    pending messages (about half the rows flagged, counts 1-3), on the
    CPU."""
    g = torch.Generator().manual_seed(seed)
    n = seeds * cfg.n_nodes
    mem = init_memory(n, cfg.memory_dim, cfg.msg_table_dim, torch.bfloat16,
                      torch.bfloat16, device="cpu")
    mem.memory.copy_(torch.randn(mem.memory.shape, generator=g))
    mem.last_update.copy_(torch.rand(n, generator=g) * 10)
    mem.messages.copy_(torch.randn(mem.messages.shape, generator=g))
    flag = torch.rand(n, generator=g) < 0.5
    mem.messages[:, -1] = flag.to(mem.messages.dtype)
    mem.msg_ts.copy_(mem.last_update + torch.rand(n, generator=g))
    mem.msg_count.copy_(torch.where(
        flag, torch.randint(1, 4, (n,), generator=g).float(), 0.0))
    return mem


def check_unmasked_protocol(device, aggregator: str, seeds: int,
                            b: int = 60, batches: int = 4,
                            **options) -> None:
    """``eval_protocol`` with ``valid=None`` and with an all-ones mask, from
    the same :func:`pending_tables` of ``seeds`` lanes on ``device``, over
    ``batches`` batches of ``b`` events whose senders repeat: every table
    bit-equal after every batch, and the memory moved."""
    n_events = b * batches
    cols, ef = stream(n_events)
    cfg = config("streaming", n_events, aggregator=aggregator, **options)
    if seeds > 1:
        params = init_seed_params(cfg.replace(parallel_runs=seeds), device)
        offs = torch.arange(seeds, dtype=torch.int64,
                            device=device) * cfg.n_nodes
    else:
        params = init_tgn_params(cfg, torch.Generator().manual_seed(1),
                                 device)
        offs = None
    ef = torch.as_tensor(ef, device=device)
    start = pending_tables(cfg, seeds)
    masked = MemoryState(*(x.to(device, copy=True) for x in start))
    unmasked = MemoryState(*(x.to(device, copy=True) for x in start))
    for lo in range(0, n_events, b):
        src, dst, t, eidx = (torch.as_tensor(c[lo: lo + b], device=device)
                             for c in cols)
        src, dst, eidx = (x.to(torch.int32) for x in (src, dst, eidx))
        assert len(np.unique(cols[0][lo: lo + b])) < b  # repeated senders
        ones = torch.ones(b, dtype=torch.bool, device=device)
        eval_protocol(cfg, params, masked, ef, src, dst, t, eidx, ones, offs)
        eval_protocol(cfg, params, unmasked, ef, src, dst, t, eidx, None,
                      offs)
        for name, x, y in zip(MemoryState._fields, unmasked, masked):
            assert torch.equal(x, y), (lo, name)
    assert not torch.equal(unmasked.memory.cpu(), start.memory)
