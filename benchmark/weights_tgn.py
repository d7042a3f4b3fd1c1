"""The TGN tower's weights made from the seed on the device: one normal and
one uniform draw of a generator on the run's device fill every parameter
(``reference.tgn.layout``), as ``weights.make_params`` fills the diffusion
tower's. The same seed gives the same numbers on the same device."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.model import Dims
from benchmark.reference.tgn import layout


def make_params(dims: Dims, n_layer: int, seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one seed."""
    spec = layout(dims, n_layer)
    size = sum(int(np.prod(shape)) for _, shape, _, _ in spec)
    gen = torch.Generator(device).manual_seed(int(seed))
    normal = torch.randn(size, generator=gen, device=device)
    uniform = torch.rand(size, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape, law, scale in spec:
        n = int(np.prod(shape))
        src = normal if law == "normal" else uniform
        out[name] = (src[at: at + n] * scale).reshape(shape).contiguous()
        at += n
    return out
