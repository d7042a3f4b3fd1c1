"""The port's link-prediction metrics (zebra_tpu_torch/ops/metrics.py)
against the JAX functions and sklearn, with tied scores and padded rows.

Bars: AP and AUC within 1e-6 of JAX (the same f32 sums, in another order
only inside cumsum and the reductions), rank accuracy exact; against
sklearn on tie-free scores within 1e-5, as the JAX tests hold JAX."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sklearn.metrics import average_precision_score, roc_auc_score

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.ops import metrics as jm
from zebra_tpu_torch.ops import metrics as pm

NAMES = ("masked_ap", "masked_auc", "masked_rank_acc")


def _batch(seed, b=200, ties=False, n_invalid=0):
    rs = np.random.RandomState(seed)
    pos = rs.beta(3, 2, b).astype(np.float32)
    neg = rs.beta(2, 3, b).astype(np.float32)
    if ties:  # coarse scores: many ties across and within pos/neg
        pos, neg = np.round(pos * 8) / 8, np.round(neg * 8) / 8
        neg[:10] = pos[:10]
    valid = np.ones(b, bool)
    if n_invalid:
        valid[rs.choice(b, n_invalid, replace=False)] = False
    return pos, neg, valid


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ties,n_invalid", [(False, 0), (True, 0),
                                            (False, 37), (True, 37),
                                            (True, 200)])
def test_metrics_match_jax(name, ties, n_invalid):
    pos, neg, valid = _batch(7, ties=ties, n_invalid=n_invalid)
    got = getattr(pm, name)(*(torch.from_numpy(a) for a in (pos, neg, valid)))
    want = getattr(jm, name)(*(jnp.asarray(a) for a in (pos, neg, valid)))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want),
                               rtol=0 if name == "masked_rank_acc" else 1e-6)


def test_metrics_match_sklearn_on_valid_rows():
    pos, neg, valid = _batch(3, n_invalid=50)
    p, n = pos[valid], neg[valid]
    true = np.concatenate([np.ones(len(p)), np.zeros(len(n))])
    pred = np.concatenate([p, n])
    args = [torch.from_numpy(a) for a in (pos, neg, valid)]
    np.testing.assert_allclose(float(pm.masked_ap(*args)),
                               average_precision_score(true, pred), rtol=1e-5)
    np.testing.assert_allclose(float(pm.masked_auc(*args)),
                               roc_auc_score(true, pred), rtol=1e-5)
    np.testing.assert_allclose(float(pm.masked_rank_acc(*args)),
                               np.mean(p >= n), rtol=1e-6)
