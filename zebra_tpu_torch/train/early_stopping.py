"""Early stopping on validation AP (copy of
``zebra_tpu/train/early_stopping.py``): stop after ``max_round`` epochs
without a relative improvement greater than ``tolerance``."""

from __future__ import annotations

import numpy as np


class EarlyStopMonitor:
    def __init__(self, max_round: int = 3, higher_better: bool = True,
                 tolerance: float = 1e-10):
        self.max_round = max_round
        self.num_round = 0
        self.epoch_count = 0
        self.best_epoch = 0
        self.last_best = None
        self.higher_better = higher_better
        self.tolerance = tolerance

    def early_stop_check(self, curr_val: float) -> bool:
        if not self.higher_better:
            curr_val *= -1
        if self.last_best is None:
            self.last_best = curr_val
        elif (curr_val - self.last_best) / np.abs(self.last_best) > self.tolerance:
            self.last_best = curr_val
            self.num_round = 0
            self.best_epoch = self.epoch_count
        else:
            self.num_round += 1
        self.epoch_count += 1
        return self.num_round >= self.max_round
