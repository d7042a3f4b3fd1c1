"""Bochner-style fixed time encoding ``cos(Δt·ω)`` with
``ω_j = 1 / 10^{linspace(0, 9, d)_j}`` (counterpart of
``zebra_tpu/models/time_encoding.py``).

``torch.cos`` is the accurate cosine on both devices (PyTorch builds its
CUDA kernels without fast math); Δt reaches ~1e5 on real streams, where an
approximate ``__cosf`` would lose the low frequencies' phase."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def time_basis(dim: int, device=None) -> torch.Tensor:
    """The fixed frequency vector ω, f32 [dim] (the JAX package's numpy
    expression, so both packages hold the same bits). Made once per device:
    a host-to-card copy per call would wait for the stream to drain. The
    tensor is shared; callers must not write to it."""
    basis = 1.0 / 10.0 ** np.linspace(0, 9, dim, dtype=np.float32)
    return torch.from_numpy(np.asarray(basis, np.float32)).to(device)


def time_encode(dt: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """cos(Δt·ω) with a trailing feature axis appended: [...] → [..., dim]."""
    return torch.cos(dt[..., None] * basis)
