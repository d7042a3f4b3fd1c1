"""The packed T-PPR row layout, shared by the scan (``streaming.py``) and the
merge (``merge.py``).

One f32 row per node, exactly the JAX layout:

    [N, F]   F = M·(4k+1): per ensemble member the four k-vectors
             [weight | neighbor id | edge id | entry timestamp],
             then the M running norms  n ← n·β + β."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# field indices in the packed row
_W, _NBR, _EIDX, _TS = 0, 1, 2, 3


class TpprParams(NamedTuple):
    """Ensemble hyperparameters, one (α, β) per member, and the top-k."""

    alpha: Tuple[float, ...]
    beta: Tuple[float, ...]
    k: int

    @classmethod
    def create(cls, alpha_list, beta_list, k: int) -> "TpprParams":
        return cls(
            alpha=tuple(float(a) for a in alpha_list),
            beta=tuple(float(b) for b in beta_list),
            k=int(k),
        )


def row_width(n_tppr: int, k: int) -> int:
    return n_tppr * (4 * k + 1)


def split_rows(rows: torch.Tensor, m: int, k: int):
    """rows [..., F] → (fields [..., M, 4, k], norm [..., M]) views."""
    fields = rows[..., : 4 * m * k].reshape(rows.shape[:-1] + (m, 4, k))
    return fields, rows[..., 4 * m * k:]


def pack_rows(fields: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """(fields [..., M, 4, k], norm [..., M]) → rows [..., F]."""
    flat = fields.reshape(fields.shape[:-3] + (-1,))
    return torch.cat([flat, norm], dim=-1)
