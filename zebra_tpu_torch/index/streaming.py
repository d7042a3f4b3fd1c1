"""Streaming top-k temporal personalized PageRank (T-PPR) index, in PyTorch
(counterpart of ``zebra_tpu/index/streaming.py``).

The state is one packed f32 row per node, exactly the JAX layout
(``layout.py``): ``data`` f32 [N, F], F = M·(4k+1).

Ids are stored as f32 *values*, exact below 2^24; tables or edge ids at or
above that width are refused (:func:`check_id_width`).

The SANTA update of an edge reads the pre-edge rows of both endpoints and
writes both new rows. :func:`edge_step` does it for one wave of
node-disjoint edges (gather → ``santa_merge`` kernel → masked scatter).
:func:`streaming_scan` and :func:`fill_scan` run a chunk of events in
stream order through ``scan.scan``: one ``santa_scan`` kernel launch on the
card, a loop of steps of the plain merge on the CPU. Both update ``data``
in place."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.index.layout import (  # noqa: F401  (re-exported)
    _EIDX,
    _NBR,
    _TS,
    _W,
    TpprParams,
    pack_rows,
    row_width,
    split_rows,
)
from zebra_tpu_torch.index.scan import scan, step
from zebra_tpu_torch.utils.profiling import READ_IDS, span

# ids are held as f32 values: exact below 2^24
ID_LIMIT = 1 << 24


def check_id_width(n_nodes: int = 0, n_edges: int = 0) -> None:
    """Raise when node or edge ids would not round-trip through f32."""
    for what, n in (("n_nodes", n_nodes), ("n_edges", n_edges)):
        if int(n) >= ID_LIMIT:
            raise ValueError(
                f"{what}={int(n)} ≥ 2^24: the packed T-PPR rows hold ids as "
                "f32 values, exact only below 2^24"
            )


class TpprState(NamedTuple):
    data: torch.Tensor  # f32 [N, F] packed rows (module docstring)


class TpprQueries(NamedTuple):
    """Extraction results, model-facing; fields [E, M, 3, k] from the scan,
    [M, Q, k] once a caller flattens the query blocks. Empty slots hold
    nbr 0 / eidx 0 / weight 0 and dt equal to the query time."""

    nbr: torch.Tensor   # i32
    eidx: torch.Tensor  # i32
    dt: torch.Tensor    # f32
    w: torch.Tensor     # f32


def init_tppr_state(n_tppr: int, n_nodes: int, k: int,
                    device=None) -> TpprState:
    check_id_width(n_nodes=n_nodes)
    dev = resolve_device(device)
    return TpprState(data=torch.zeros((n_nodes, row_width(n_tppr, k)),
                                      dtype=torch.float32, device=dev))


def unpack_queries(rows3: torch.Tensor, e_ts: torch.Tensor, n_tppr: int,
                   k: int) -> TpprQueries:
    """Raw rows [E, 3, F] + query times [E] → TpprQueries fields
    [E, M, 3, k]."""
    fields, _ = split_rows(rows3, n_tppr, k)        # [E, 3, M, 4, k]
    perm = (0, 2, 1, 3)
    return TpprQueries(
        nbr=fields[:, :, :, _NBR].to(torch.int32).permute(perm),
        eidx=fields[:, :, :, _EIDX].to(torch.int32).permute(perm),
        dt=(e_ts[:, None, None, None] - fields[:, :, :, _TS]).permute(perm),
        w=fields[:, :, :, _W].permute(perm),
    )


def _columns(data, src, dst, neg, e_ts, e_idx, valid,
             n_nodes: Optional[int] = None):
    """The event columns on ``data``'s device: i32 ids, f32 times, bool
    valid, contiguous (``neg`` [E], or [E, S] with one negative per seed).
    One host read (the ``zebra.read_ids`` span) checks, on the ids as given
    (before they narrow to i32), that node ids lie in [0, N) and edge ids
    below 2^24. N is ``data``'s rows, or ``n_nodes`` where ``data`` holds a
    rank's block of them."""
    dev = data.device
    n_nodes = data.shape[0] if n_nodes is None else n_nodes
    as_t = lambda x, dt: torch.as_tensor(x).to(device=dev,
                                               dtype=dt).contiguous()
    src, dst, neg, e_idx = (as_t(x, torch.int64)
                            for x in (src, dst, neg, e_idx))
    e_ts = as_t(e_ts, torch.float32)
    valid = as_t(valid, torch.bool)
    if e_idx.numel():
        with span(READ_IDS):
            ids = torch.cat([src, dst, neg.reshape(-1)])
            lo, hi, e_max = torch.stack([ids.min(), ids.max(),
                                         e_idx.max()]).tolist()
        check_id_width(n_edges=e_max + 1)
        if lo < 0 or hi >= n_nodes:
            raise ValueError(
                f"node ids must lie in [0, {n_nodes}), got "
                f"[{lo}, {hi}]")
    src, dst, neg, e_idx = (x.to(torch.int32) for x in (src, dst, neg, e_idx))
    return src, dst, neg, e_ts, e_idx, valid


def edge_step(state: TpprState, src, dst, neg, e_ts, e_idx, valid,
              params: TpprParams) -> Tuple[TpprState, torch.Tensor]:
    """The SANTA update of W edges whose rows are pairwise disjoint (one
    wave): extraction rows [W, 3, F] from the pre-edge state, then the merge
    (the ``santa_merge`` kernel on the card) and the masked scatter of both
    endpoints' new rows. Padding edges (``valid`` False) leave their rows
    untouched. Updates ``state`` in place and returns it with the extraction
    rows."""
    data = state.data
    src, dst, neg, e_ts, e_idx, valid = _columns(data, src, dst, neg, e_ts,
                                                 e_idx, valid)
    ids = torch.stack([src, dst, neg], dim=1).to(torch.int64)
    rows3 = torch.empty((src.shape[0], 3, data.shape[1]), dtype=data.dtype,
                        device=data.device)
    step(data, ids, rows3, src, dst, e_idx, e_ts,
         None if bool(valid.all()) else valid, params)
    return state, rows3


def streaming_scan(state: TpprState, params: TpprParams, src, dst, neg, e_ts,
                   e_idx, valid) -> Tuple[TpprState, TpprQueries]:
    """Scan a chunk of the edge stream in order (``scan.scan``: one
    ``santa_scan`` launch on the card). Updates ``state`` in place; returns
    it and the pre-edge queries, fields [E, M, 3, k]."""
    cols = _columns(state.data, src, dst, neg, e_ts, e_idx, valid)
    rows = scan(state.data, params, *cols, extract=True)
    return state, unpack_queries(rows, cols[3], len(params.alpha), params.k)


def fill_scan(state: TpprState, params: TpprParams, src, dst, e_ts, e_idx,
              valid) -> TpprState:
    """Replay a chunk of the stream into the state without extraction
    (``zebra_tpu/index/streaming.py:fill_scan``; neg is src and never read).
    One ``santa_scan`` launch on the card. Updates ``state`` in place and
    returns it."""
    cols = _columns(state.data, src, dst, src, e_ts, e_idx, valid)
    scan(state.data, params, *cols, extract=False)
    return state


def read_topk(state: TpprState, nodes3: torch.Tensor, t_q: torch.Tensor,
              n_tppr: int, k: int) -> TpprQueries:
    """Read-only extraction: the current top-k of each query node at the
    query time (one row gather; the serving fast path). nodes3 [B, nb] ids,
    t_q [B] → fields [B, M, nb, k]."""
    rows = state.data[nodes3.to(torch.int64)]
    return unpack_queries(rows, t_q, n_tppr, k)
