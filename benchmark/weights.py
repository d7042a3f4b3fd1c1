"""Weights and edge features made from the seed on the device: one normal
and one uniform draw of a generator on the run's device fill every
parameter (``reference.model.layout``), and one normal draw the edge
features. The same seed gives the same numbers on the same device."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.model import Dims, layout


def make_params(dims: Dims, seed: int, device, lanes: int = 1
                ) -> Dict[str, torch.Tensor]:
    """{name: tensor}; with ``lanes`` > 1 every leaf has a leading lane
    axis, lane s drawn from seed + s."""
    spec = layout(dims)
    size = sum(int(np.prod(shape)) for _, shape, _, _ in spec)
    out: Dict[str, list] = {name: [] for name, _, _, _ in spec}
    for s in range(lanes):
        gen = torch.Generator(device).manual_seed(int(seed) + s)
        normal = torch.randn(size, generator=gen, device=device)
        uniform = torch.rand(size, generator=gen, device=device) * 2 - 1
        at = 0
        for name, shape, law, scale in spec:
            n = int(np.prod(shape))
            src = normal if law == "normal" else uniform
            out[name].append((src[at: at + n] * scale).reshape(shape))
            at += n
    if lanes == 1:
        return {k: v[0].contiguous() for k, v in out.items()}
    return {k: torch.stack(v) for k, v in out.items()}


def edge_features(n_rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """f32 [n_rows, dim], N(0, 0.1²), row 0 zero (the padding edge)."""
    gen = torch.Generator(device).manual_seed(int(seed))
    feats = torch.randn((n_rows, dim), generator=gen, device=device) * 0.1
    feats[0] = 0.0
    return feats


def lane(params: Dict[str, torch.Tensor], s: int) -> Dict[str, torch.Tensor]:
    return {k: v[s] for k, v in params.items()}
