"""Serving's eval memory protocol without a mask (``train/step.py:
eval_protocol(valid=None)``, what ``LinkPredictor.observe`` runs) against
the same protocol under an all-ones mask, and the rule that sends an
observe's protocol to a CUDA graph (``train/graphs.py:protocol_replays``,
``ProtocolGraphs``), on the CPU. The graphs themselves run on the card:
``test_torch_serve_graphs_card.py``.

Bit-equal after every batch: all five tables, under ``last`` and ``mean``,
one seed and three seed lanes (``offs``), from tables holding pending
messages, over batches whose senders repeat."""

import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from torch_serve_cases import check_unmasked_protocol, config, predictor
from zebra_tpu_torch.train.graphs import protocol_replays

B = 60


@pytest.mark.parametrize("aggregator,seeds,options", [
    ("last", 1, {}),
    ("mean", 1, {}),
    ("last", 3, {}),
    ("mean", 3, {}),
    ("last", 1, dict(message_function="mlp")),
])
def test_unmasked_protocol_equals_all_ones_mask(aggregator, seeds, options):
    check_unmasked_protocol("cpu", aggregator, seeds, **options)


@pytest.mark.parametrize("device,options,replays", [
    ("cuda", {}, True),
    ("cuda", dict(aggregator="mean"), True),
    ("cuda", dict(use_source_embedding_in_message=True), False),
    ("cuda", dict(use_destination_embedding_in_message=True), False),
    ("cpu", {}, False),
])
def test_protocol_replay_rule(device, options, replays):
    cfg = config("streaming", 10, **options)
    assert protocol_replays(cfg, torch.device(device)) is replays


@pytest.mark.parametrize("kind,options", [
    ("streaming", {}),
    ("streaming", dict(use_source_embedding_in_message=True)),
    ("pruning", {}),
    ("ensemble", {}),
])
def test_cpu_observes_run_eagerly(kind, options):
    pred, cols = predictor(kind, "cpu", 3 * B, **options)
    for lo, hi in ((0, B), (B, 2 * B), (2 * B, 2 * B + 25),
                   (2 * B + 25, 3 * B)):
        pred.observe(*(c[lo: hi] for c in cols))
    assert (pred.protocol_captures, pred.protocol_replays,
            pred.protocol_eager) == (0, 0, 4)
    assert pred.mem.memory.float().abs().max() > 0
