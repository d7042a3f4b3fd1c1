"""Checkpoint files of the port (counterpart of
``zebra_tpu/train/checkpoint.py``).

A checkpoint is ``torch.save`` of ``{"magic", "version", "tree"}``, where the
tree holds tensors and plain Python values only (dicts, lists, tuples,
numbers, strings, None): it loads with ``torch.load(weights_only=True)``,
which runs no code from the file. Tensors are stored on the CPU, so a file
written on the card loads on the CPU and the other way round; a bf16 table
stays bf16. The write goes to ``path + ".tmp"`` and is moved into place, so
a reader never sees half a file. A newer version is refused.

The JAX package's checkpoints pickle ``zebra_tpu`` classes and numpy
arrays. ``weights_only`` refuses them without importing anything, and the
port does not read them: reading one would mean importing the JAX
package."""

from __future__ import annotations

import os
import pickle
from typing import Any

import torch

MAGIC = "zebra_tpu_torch_checkpoint"
VERSION = 1


def _to_cpu(tree: Any) -> Any:
    """Every tensor of a tree of dicts, lists and tuples, detached on the
    CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` (through ``path + ".tmp"``)."""
    payload = {"magic": MAGIC, "version": VERSION, "tree": _to_cpu(tree)}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    """The tree of a file ``save_checkpoint`` wrote, tensors on the CPU.
    Raises ``ValueError`` for any other file, and for a newer version."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path!r} is not a zebra_tpu_torch checkpoint: it holds objects "
            "other than tensors and plain values (a checkpoint of the JAX "
            "package pickles zebra_tpu classes, which the port does not "
            "read)") from e
    if not (isinstance(payload, dict) and payload.get("magic") == MAGIC):
        raise ValueError(f"{path!r} is not a zebra_tpu_torch checkpoint")
    version = payload["version"]
    if version > VERSION:
        raise ValueError(
            f"checkpoint {path!r} has version {version}, newer than this "
            f"build's {VERSION}: refusing to guess at its layout")
    return payload["tree"]
