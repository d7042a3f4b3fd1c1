"""The adjacency fold on the card: ``append_events`` on CUDA at MOOC's
size (7,047 users, 97 items, the 411,749-event history), twenty b = 200
folds of the stream's continuation, each ``torch.equal`` to
``build_neighbor_index`` over every event so far (arena, offsets, keys,
times) with the same ``max_degree``. ``python3 -m pytest --noconftest -m
card tests/test_torch_fold_card.py`` (the package's conftest loads JAX,
which the card's machine does not hold); skips without a CUDA device. The
same cases at small sizes on the CPU: ``tests/test_torch_fold.py``."""

import numpy as np
import pytest
import torch

from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index.neighbor_finder import (
    append_events,
    build_neighbor_index,
)

pytestmark = pytest.mark.card

USERS, ITEMS, HISTORY, B, FOLDS = 7_047, 97, 411_749, 200, 20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_appends_equal_the_rebuild_at_mooc_size(card):
    data, _ = synthetic_stream(HISTORY + FOLDS * B, USERS, ITEMS,
                               edge_dim=0, seed=5)
    n = int(max(data.sources.max(), data.destinations.max())) + 1
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32).astype(np.float64),
            data.edge_idxs)
    index = build_neighbor_index(*(c[:HISTORY] for c in cols), n, card)
    for end in range(HISTORY + B, HISTORY + FOLDS * B + 1, B):
        index = append_events(index, *(c[end - B: end] for c in cols))
        assert index is not None
        want = build_neighbor_index(*(c[:end] for c in cols), n, card)
        for f in ("arena", "offsets", "keys", "times"):
            assert torch.equal(getattr(index, f), getattr(want, f)), (end, f)
        assert index.max_degree == want.max_degree
