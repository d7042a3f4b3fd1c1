"""zebra_tpu_torch — the PyTorch/CUDA port of zebra_tpu for NVIDIA Hopper.

A second package beside the JAX one (``zebra_tpu``), which stays the
reference the port is tested against. Module names mirror the JAX package so
each counterpart is easy to find; inside, the code is PyTorch: explicit
devices, explicit ``torch.Generator``s, ``nn.Module`` parameter containers
and plain functions on tensors.

This package never imports ``jax`` or ``zebra_tpu``. Its entry points run on
CUDA unless the caller passes ``device="cpu"`` (see :mod:`.device`); on a
CUDA tensor every hand-written kernel launches (the SANTA merge,
``csrc/santa_merge.cu`` and ``csrc/santa_scan.cu``), and on a CPU tensor its
plain PyTorch version runs.

Ported so far, for the streaming and pruning strategies, every tower
(diffusion, graph_attention, graph_sum, identity, time), the GRU/RNN
updater and both aggregators, S seeds on one device or sharded whole over
D processes (:mod:`.parallel`), with the host-backup protocol: the training
run (``python -m zebra_tpu_torch.train``, :mod:`.cli`;
``train.loop.Trainer``: ``fit`` with early stopping and state files,
``train_epoch``, ``validate``, ``test``; ``train.node_classification``),
preprocessing (``python -m zebra_tpu_torch.data.preprocess``) and serving
(``serve.LinkPredictor``: ``observe``, ``score``, ``from_trainer``,
``from_checkpoint``).
"""

import torch

from zebra_tpu_torch.device import resolve_device

# The port's numerics: float32 matrix products and convolutions run in full
# float32 on CUDA, as the JAX reference's f32 path does, never in TF32. Set
# once, when the package is imported.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
