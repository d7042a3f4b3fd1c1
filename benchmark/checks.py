"""The numbers that decide ``correct``: each a distance between what the
timed path produced and what the plain reference works out, never a
reading of the program against itself."""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch


def rel_gap(got: Iterable[float], ref: Iterable[float]) -> float:
    """The widest |got − ref| / |ref|."""
    g = np.asarray(list(got), np.float64)
    r = np.asarray(list(ref), np.float64)
    return float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-30)))


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leave_out: Iterable[str] = ()) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    norms_r = {k: float(v.double().norm()) for k, v in ref.items()}
    med = float(np.median(list(norms_r.values())))
    return {k: abs(float(got[k].double().norm()) - n) / max(n, med, 1e-30)
            for k, n in norms_r.items() if k not in leave_out}


def leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leave_out: Iterable[str] = ()) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, ref, leave_out).values(), default=0.0)


def quiet_leaves(grads: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: Adam moves them by round-off alone."""
    norms = {k: float(v.double().norm()) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n < 1e-3 * med}


def table_gap(got, ref) -> float:
    """Σ|got − ref| / Σ|ref| over a table."""
    g = torch.as_tensor(got).double()
    r = torch.as_tensor(ref).double()
    return float((g - r).abs().sum() / r.abs().sum().clamp(min=1e-30))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {value, limit}} in the limits' order and whether every number
    lies within its limit (a number that is not finite never does; a cell
    without limits is never correct)."""
    out = {}
    ok = bool(limits)
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        out[name] = {"value": v, "limit": limit}
        ok = ok and bool(np.isfinite(v)) and v <= limit
    return dict(checks=out, correct=ok)
