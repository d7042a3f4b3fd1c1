"""Negative edge sampling (numpy copy of ``zebra_tpu/data/sampler.py``: the
same seeds give identical draws).

Uniform over the unique source / destination nodes of a stream, from a
fixed ``RandomState`` for the eval streams (seeds 0/2/3) or from one a
caller passes in (the train negatives of an epoch)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class RandEdgeSampler:
    def __init__(self, src_list, dst_list, seed: Optional[int] = None):
        self.seed = seed
        self.src_list = np.unique(np.asarray(src_list))
        self.dst_list = np.unique(np.asarray(dst_list))
        if seed is not None:
            self.random_state = np.random.RandomState(seed)

    def sample(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        rs = np.random if self.seed is None else self.random_state
        return self.sample_with(rs, size)

    def sample_with(self, rs, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """One (src, dst) draw from ``rs``, src indices first."""
        src_index = rs.randint(0, len(self.src_list), size)
        dst_index = rs.randint(0, len(self.dst_list), size)
        return self.src_list[src_index], self.dst_list[dst_index]

    def reset_random_state(self):
        if self.seed is None:
            raise ValueError("only a seeded sampler can be reset")
        self.random_state = np.random.RandomState(self.seed)

    def sample_eval_negatives(self, n: int, bs: int) -> np.ndarray:
        """Negatives for a whole eval stream: the seeded state is reset, then
        drawn batch by batch as (src, dst) pairs of min(bs, remaining); the
        dst draws are the negatives."""
        self.reset_random_state()
        negs = np.empty(n, dtype=self.dst_list.dtype)
        for lo in range(0, n, bs):
            size = min(bs, n - lo)
            _, negs[lo: lo + size] = self.sample(size)
        return negs
