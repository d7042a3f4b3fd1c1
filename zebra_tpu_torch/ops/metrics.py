"""Link-prediction metrics on the device (counterpart of
``zebra_tpu/ops/metrics.py``): per batch, with a validity mask so the
padded tail of a stream counts nothing. Inputs are the positive and
negative scores of one batch, one negative per positive; each metric
returns a 0-dim tensor on their device. Scores with a leading seed axis
([S, b], the mask [b] shared) give one value per seed, [S]."""

from __future__ import annotations

import torch


def masked_ap(pos: torch.Tensor, neg: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Average precision over the 2·n_valid scored samples (positives
    labelled 1): a stable descending sort, invalid rows ranked last with
    label 0. Equals sklearn's average_precision_score for tie-free
    scores."""
    scores = torch.cat([pos, neg], dim=-1)
    labels = torch.cat([valid, torch.zeros_like(valid)]).float()
    s = torch.where(torch.cat([valid, valid]), scores, -torch.inf)
    order = torch.sort(-s, stable=True).indices
    l_sorted = labels[order]
    ranks = torch.arange(1, s.shape[-1] + 1, dtype=torch.float32,
                         device=s.device)
    precision = torch.cumsum(l_sorted, -1) / ranks
    return (precision * l_sorted).sum(-1) / labels.sum().clamp(min=1.0)


def masked_auc(pos: torch.Tensor, neg: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """ROC-AUC as the pairwise Mann-Whitney statistic over valid pairs,
    each tied pair counting ½."""
    pair_valid = valid[:, None] & valid[None, :]
    gt = ((pos[..., :, None] > neg[..., None, :]) & pair_valid).sum((-2, -1))
    eq = ((pos[..., :, None] == neg[..., None, :]) & pair_valid).sum((-2, -1))
    return (gt + 0.5 * eq) / pair_valid.sum().clamp(min=1)


def masked_rank_acc(pos: torch.Tensor, neg: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Share of valid events whose positive outscores its own negative;
    a tie counts as correct."""
    correct = ((pos >= neg) & valid).sum(-1)
    return correct / valid.sum().clamp(min=1)
