"""What the harness hands the program (``zebra_tpu_torch``) and reads back
from it: its configuration, its splits, its parameter tree, and the state
it exposes (packed index rows, memory tables, optimizer moments)."""

from __future__ import annotations

import tempfile
from typing import Dict

import numpy as np
import torch
from torch import nn

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import Data, DatasetSplits

from benchmark.reference.model import Dims
from benchmark.streams import Events, Split


def config(model: Dict, seed: int, **extra) -> Config:
    """The program's configuration: the file's ``model`` keys, the seed,
    and state files kept out of the checkout."""
    scratch = tempfile.gettempdir()
    return Config(**model, seed=int(seed), checkpoint_dir=scratch,
                  log_dir=scratch, **extra)


def dims(cfg: Config, edge_dim: int) -> Dims:
    return Dims(d=cfg.node_dim, t=cfg.time_dim, e=edge_dim,
                m=len(cfg.alpha_list), k=cfg.topk)


def _data(ev: Events) -> Data:
    return Data(ev.src, ev.dst, ev.t, ev.eidx, np.zeros(len(ev)))


def splits(sp: Split) -> DatasetSplits:
    return DatasetSplits(
        full=_data(sp.full), train=_data(sp.train), val=_data(sp.val),
        test=_data(sp.test), new_node_val=_data(sp.new_node_val),
        new_node_test=_data(sp.new_node_test), n_nodes=sp.n_nodes,
        n_edges=len(sp.full))


def param_tree(params: Dict[str, torch.Tensor]) -> nn.ModuleDict:
    """{"fc1.w": tensor, …} → the program's two-level parameter tree."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, v in params.items():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = nn.Parameter(v.detach().clone(),
                                                        requires_grad=False)
    return nn.ModuleDict({k: nn.ParameterDict(v) for k, v in tree.items()})


def first_moments(trainer) -> Dict[str, torch.Tensor]:
    """Adam's first moment of every parameter (stacked over the lanes of a
    seed-parallel trainer), keyed like the parameter tree; zero where the
    optimizer holds none."""
    opt = trainer.optimizer
    named = list(trainer.params.named_parameters())
    if hasattr(opt, "exp_avg"):
        return {n: m.detach().clone() for (n, _), m in zip(named,
                                                           opt.exp_avg)}
    return {n: opt.state[p]["exp_avg"].detach().clone()
            if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
            for n, p in named}


def parameters(trainer) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in trainer.params.named_parameters()}
