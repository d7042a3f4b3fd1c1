"""Carry weights and state between the JAX package and the port, through
numpy (the port never imports JAX).

- params: a numpy pytree ``{"fc1": {"w", "b"}, ..., "cell": {"w_ih", ...}}``
  (``jax.tree.map(np.asarray, params)``) ↔ the port's ``nn.ModuleDict``,
  also into a port ``Trainer`` (:func:`load_trainer_params`), whose
  ``params`` come back through :func:`params_to_numpy`. JAX's per-layer
  lists (``attn``, ``sum_fc1``, ``sum_fc2``) become one port name per layer
  (``attn_0`` …) and its nested MergeLayer dicts (``merge_fc1: {w, b}``)
  leaves ``merge_fc1_w``, ``merge_fc1_b``; the way back restores JAX's
  tree. A seed-parallel tree carries a leading [S] axis on every leaf, and
  crosses as it is;
- memory: any object with ``MemoryState``'s five fields ↔ the port's
  ``MemoryState``; a seed-parallel run's tables are [S, N, ...] (the JAX
  Trainer's and ``EnsemblePredictor``'s layout), and the port Trainer's
  flat [S·N, ...] tables come back in that layout
  (``memory_to_numpy(mem, n_seeds=S)``);
- index: any object with a ``data`` field ↔ ``TpprState`` (one index for
  all seeds).

``np.asarray`` of a bf16 JAX array is an ``ml_dtypes.bfloat16`` array,
which ``torch.from_numpy`` refuses: such arrays cross as float32 (a bf16 →
f32 → bf16 round trip is exact) and come back from the port as float32.
The memory tables take their dtypes from the config."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from zebra_tpu_torch.config import Config, torch_dtype
from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.index.streaming import TpprState
from zebra_tpu_torch.models.memory import MemoryState


def to_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """numpy (bf16 included) → tensor on ``device``, cast to ``dtype`` if
    given; a bf16 array keeps bf16 when no ``dtype`` is asked for."""
    a = np.asarray(a)
    keep_bf16 = a.dtype.name == "bfloat16"
    if keep_bf16:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype is None and keep_bf16:
        dtype = torch.bfloat16
    return t.to(device=resolve_device(device), dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor → numpy on the host; bf16 comes back as (exact) float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


# JAX's per-layer parameter lists, and the nested dicts inside a layer
LISTED = ("attn", "sum_fc1", "sum_fc2")
NESTED = ("merge_fc1", "merge_fc2")


def _flat_layer(layer: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX layer dict → one level: ``{"merge_fc1": {"w": …}}`` →
    ``{"merge_fc1_w": …}``."""
    out = {}
    for key, v in layer.items():
        if isinstance(v, Mapping):
            out.update({f"{key}_{k}": x for k, x in v.items()})
        else:
            out[key] = v
    return out


def params_from_numpy(tree: Mapping[str, Any], device=None) -> nn.ModuleDict:
    """A JAX parameter tree of numpy arrays → the port's tree on
    ``device``."""
    dev = resolve_device(device)
    layers = {}
    for name, v in tree.items():
        if isinstance(v, (list, tuple)):
            layers.update({f"{name}_{l}": _flat_layer(x)
                           for l, x in enumerate(v)})
        else:
            layers[name] = _flat_layer(v)
    return nn.ModuleDict({
        name: nn.ParameterDict({
            key: to_tensor(v, dev, torch.float32) for key, v in layer.items()
        })
        for name, layer in layers.items()
    }).requires_grad_(False)


def load_trainer_params(trainer, tree: Mapping[str, Mapping[str, Any]]) -> None:
    """Train a port ``Trainer`` from the numpy params ``tree`` (a JAX
    Trainer's, say; stacked [S, ...] for a seed-parallel Trainer) from here
    on, with a fresh Adam state."""
    trainer.set_params(params_from_numpy(tree, trainer.device))


def params_to_numpy(params: nn.ModuleDict) -> Dict[str, Any]:
    """The port's tree → numpy arrays in JAX's layout (per-layer lists,
    nested MergeLayer dicts)."""
    tree: Dict[str, Any] = {}
    for name, layer in params.items():
        leaves: Dict[str, Any] = {}
        for key, v in layer.items():
            nest = next((n for n in NESTED if key.startswith(n + "_")), None)
            if nest is None:
                leaves[key] = to_numpy(v)
            else:
                leaves.setdefault(nest, {})[key[len(nest) + 1:]] = to_numpy(v)
        base, _, l = name.rpartition("_")
        if base in LISTED and l.isdigit():
            tree.setdefault(base, []).append(leaves)   # layers in order
        else:
            tree[name] = leaves
    return tree


def memory_from_numpy(mem, cfg: Config, device=None) -> MemoryState:
    dev = resolve_device(device)
    tables = {"memory": torch_dtype(cfg.memory_dtype),
              "messages": torch_dtype(cfg.message_dtype)}
    return MemoryState(*(
        to_tensor(getattr(mem, f), dev, tables.get(f, torch.float32))
        for f in MemoryState._fields
    ))


def memory_to_numpy(mem: MemoryState, n_seeds: int = 1) -> MemoryState:
    """Tables → numpy; flat seed-parallel tables [S·N, ...] come back as
    [S, N, ...] when ``n_seeds`` is S."""
    out = (to_numpy(x) for x in mem)
    if n_seeds > 1:
        out = (x.reshape((n_seeds, -1) + x.shape[1:]) for x in out)
    return MemoryState(*out)


def tppr_from_numpy(state, device=None) -> TpprState:
    return TpprState(to_tensor(getattr(state, "data"), device, torch.float32))


def tppr_to_numpy(state: TpprState) -> TpprState:
    return TpprState(to_numpy(state.data))
