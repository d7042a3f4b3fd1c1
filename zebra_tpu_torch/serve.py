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
eval-mode memory protocol; ``score`` is read-only."""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    TpprQueries,
    TpprState,
    check_id_width,
    fill_scan,
    read_topk,
)
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import affinity_score, init_tgn_params
from zebra_tpu_torch.train.checkpoint import load_checkpoint
from zebra_tpu_torch.train.step import _forward, eval_store_commit


class LinkPredictor:
    """Stateful scorer over a (params, memory, index) snapshot.

    The predictor keeps its own copies of the state on ``device`` and
    updates memory and index in place as it observes events."""

    def __init__(self, cfg: Config, params, mem: MemoryState,
                 index_state: TpprState, edge_feats, device=None):
        self.device = resolve_device(device)
        check_id_width(cfg.n_nodes, cfg.n_edges)
        self.cfg = cfg
        dev = self.device
        self.params = copy.deepcopy(params).to(dev).requires_grad_(False)
        self.mem = MemoryState(*(x.to(dev, copy=True) for x in mem))
        self.index_state = TpprState(index_state.data.to(dev, copy=True))
        self.edge_feats = torch.as_tensor(edge_feats).to(
            dev, torch.float32, copy=True)
        self._tppr = TpprParams.create(cfg.alpha_list, cfg.beta_list, cfg.topk)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[Config] = None,
                        edge_feats=None, events=None, rebuild_every: int = 1,
                        run_index: int = 0, ensemble: bool = False,
                        device=None) -> "LinkPredictor":
        """A predictor over a ``Trainer.save_state`` file, with no live
        Trainer (the deployment path). ``cfg`` defaults to the one stored in
        the file; ``edge_feats`` to zeros, which a model trained with real
        edge features refuses. ``events`` and ``rebuild_every`` serve the
        adjacency-index strategies, which this slice's Config refuses; they
        are accepted so a JAX call carries over, and unused. ``run_index``
        and ``ensemble`` select seeds of a seed-parallel file: the seed axis
        is not ported yet."""
        dev = resolve_device(device)
        if ensemble or run_index:
            raise NotImplementedError(
                "zebra_tpu_torch serves one model: the seed axis "
                "(run_index, ensemble) is not ported yet (ROADMAP.md)")
        ckpt = load_checkpoint(path)
        cfg = cfg if cfg is not None else Config.from_dict(ckpt["cfg"])
        params = init_tgn_params(cfg, torch.Generator(), "cpu")
        params.load_state_dict(ckpt["params"])
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
        return cls(cfg, params, MemoryState(**ckpt["mem"]),
                   TpprState(ckpt["index_state"]), edge_feats, device=dev)

    @classmethod
    def from_trainer(cls, trainer) -> "LinkPredictor":
        """A predictor over a port Trainer's current params, memory, index
        and edge features, on the Trainer's device (copies: the Trainer
        trains on undisturbed)."""
        return cls(trainer.cfg, trainer.params, trainer.mem,
                   trainer.index_state, trainer.edge_feats,
                   device=trainer.device)

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32)).to(self.device)

    def _times(self, t) -> torch.Tensor:
        return torch.as_tensor(np.asarray(t, np.float32)).to(self.device)

    def _queries(self, src, dst, t, with_neg: bool = True) -> TpprQueries:
        """Read-only T-PPR top-k at the query times, fields [M, nb·b, k]:
        src‖dst‖dst blocks when ``with_neg`` (the training layout),
        src‖dst for plain scoring."""
        cols = [src, dst] + ([dst] if with_neg else [])
        q = read_topk(self.index_state, torch.stack(cols, dim=1), t,
                      self.cfg.n_tppr, self.cfg.topk)       # [B, M, nb, k]
        m, k = self.cfg.n_tppr, self.cfg.topk
        return TpprQueries(*(x.permute(1, 2, 0, 3).reshape(m, -1, k)
                             for x in q))

    def score(self, src, dst, t) -> np.ndarray:
        """P(interaction) for each (src, dst) candidate at its timestamp."""
        with torch.no_grad():
            src, dst, t = self._ids(src), self._ids(dst), self._times(t)
            b = src.shape[0]
            q = self._queries(src, dst, t, with_neg=False)
            nodes2 = torch.cat([src, dst])
            emb = _forward(self.cfg, self.params, self.mem, self.edge_feats,
                           nodes2, q)
            logit = affinity_score(self.params, emb[:b], emb[b:],
                                   self.cfg.mxu_dtype)
            return torch.sigmoid(logit).cpu().numpy()

    def observe(self, src, dst, t, eidx) -> None:
        """Ingest observed interactions: stream them through the T-PPR index
        (updated in place), then store-and-commit their messages into
        memory (the eval protocol). Edge ids must stay below 2^24
        (``fill_scan`` checks)."""
        with torch.no_grad():
            src, dst, t = self._ids(src), self._ids(dst), self._times(t)
            eidx = self._ids(eidx)
            valid = torch.ones(src.shape[0], dtype=torch.bool,
                               device=self.device)
            # no pre-edge queries: they would feed embedding-sourced
            # messages, which this slice's Config refuses
            self.index_state = fill_scan(self.index_state, self._tppr, src,
                                         dst, t, eidx, valid)
            self.mem = self._updated_mem(src, dst, t, eidx, valid)

    def _updated_mem(self, src, dst, t, eidx, valid) -> MemoryState:
        """Eval-protocol memory update for observe()."""
        return eval_store_commit(self.cfg, self.params, self.mem,
                                 self.edge_feats, src, dst, t, eidx, valid)


class EnsemblePredictor(LinkPredictor):
    """Deep-ensemble serving over a seed-parallel snapshot: not ported yet
    (ROADMAP.md)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "zebra_tpu_torch serves one model; EnsemblePredictor is not "
            "ported yet (ROADMAP.md)")
