"""TGN model stack of the ported slice (counterpart of
``zebra_tpu/models/tgn.py``): parameter init and the forward, with dropout
in train mode.

- diffusion tower: a neighbor MLP fc2(relu(fc1([mem_nbr; edge_feat;
  time_enc(Δt)]))) with a weight-normalized top-k sum per ensemble member,
  plus a source MLP on the query node's memory → [·, node_dim·(M+1)];
- the GRU/RNN memory-updater cell on the raw message, or on the mlp
  message function's output (raw → raw//2 → memory_dim);
- the MergeLayer link head.

Parameters are an ``nn.ModuleDict`` of ``nn.ParameterDict``s with the JAX
pytree's keys (``affinity_fc1/2``, ``cell``, the mlp message function's
``msg_fc1/2``, and the diffusion tower's ``fc1``, ``fc2``, ``fc1_src``,
``fc2_src``) and JAX's [in, out] weight
layout, so ``params["fc1"]["w"]`` reads like the JAX code. The tree is two
levels deep: the other towers' per-layer lists are flattened to one name
per layer (``attn_0``, ``sum_fc1_0``, ``sum_fc2_0`` …) and the attention
layer's MergeLayer to leaves ``merge_fc1_w`` …; ``time_proj`` keeps its
name. :mod:`zebra_tpu_torch.bridge` carries weights across to and from
JAX's tree. Init follows the JAX distributions: Xavier-normal
tower/head weights, U(±1/√in) biases and message-function weights,
U(±1/√H) cell parameters, the attention and sum layers' and the time
projection's laws of ``zebra_tpu/models/tgn.py``; the numbers differ
because the generators differ. Dropout masks are drawn from an
explicit ``torch.Generator`` on the activations' device; they cannot equal
JAX's ``rbg`` masks, so comparisons with JAX run with dropout 0.

Seed-parallel parameters (:func:`init_seed_params`) keep this structure
with a leading [S] axis on every leaf; the forward then takes activations
with a leading [S] axis and runs all S lanes in one set of operations. The
dropout masks of lane s come from its own generator, in the order and
shapes of a single-seed forward.

A rank of a row-sharded run embeds one block of each batch's query rows
(:class:`BlockMasks`): it draws the whole batch's masks from the run's
generator, which every rank holds in the same state, and keeps its block's
rows, so its events see the one-process run's masks."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.models.attention import attention_layer_init
from zebra_tpu_torch.models.cells import CELLS, add_bias, matmul
from zebra_tpu_torch.models.time_encoding import time_basis, time_encode


def _linear_init(generator: torch.Generator, d_in: int, d_out: int,
                 xavier: bool = True) -> nn.ParameterDict:
    """Xavier-normal weight (torch Linear's U(±1/√in) when not ``xavier``)
    and a U(±1/√in) bias."""
    bound = 1.0 / d_in ** 0.5
    dev = generator.device
    if xavier:
        std = (2.0 / (d_in + d_out)) ** 0.5
        w = torch.randn((d_in, d_out), generator=generator,
                        dtype=torch.float32, device=dev) * std
    else:
        w = torch.rand((d_in, d_out), generator=generator,
                       dtype=torch.float32, device=dev) * (2 * bound) - bound
    u = torch.rand((d_out,), generator=generator, dtype=torch.float32,
                   device=dev)
    return nn.ParameterDict({"w": w, "b": u * (2 * bound) - bound})


def _tower_init(cfg: Config, generator: torch.Generator) -> dict:
    """The parameters of a tower other than diffusion: one attention or
    sum layer per hop, the time projection, or none (identity)."""
    d, em = cfg.node_dim, cfg.embedding_module
    nbr_in = d + cfg.time_dim + cfg.edge_dim
    layers = range(cfg.n_layer)
    if em == "graph_attention":
        return {f"attn_{l}": attention_layer_init(
            generator, d, cfg.edge_dim, cfg.time_dim, cfg.n_head)
            for l in layers}
    if em == "graph_sum":
        return {**{f"sum_fc1_{l}": _linear_init(generator, nbr_in, d, False)
                   for l in layers},
                **{f"sum_fc2_{l}": _linear_init(
                    generator, 2 * d + cfg.time_dim, d, False)
                   for l in layers}}
    if em == "time":
        # JODIE's NormalLinear(1, D): weight and bias ~ N(0, 1/√D)
        std = 1.0 / d ** 0.5
        draw = lambda *shape: torch.randn(shape, generator=generator,
                                          device=generator.device) * std
        return {"time_proj": nn.ParameterDict({"w": draw(1, d),
                                               "b": draw(d)})}
    return {}


def init_tgn_params(cfg: Config, generator: torch.Generator,
                    device=None) -> nn.ModuleDict:
    """Random parameters for ``cfg`` drawn from ``generator`` (on its own
    device, so a seed gives the same weights whatever ``device`` is), then
    placed on ``device``. The link head is sized by ``cfg.hidden_dim``."""
    dev = resolve_device(device)
    d = cfg.node_dim
    h = cfg.hidden_dim
    cell_init, _ = CELLS[cfg.memory_updater]
    params = {}
    if cfg.embedding_module == "diffusion":
        params.update(
            fc1=_linear_init(generator, d + cfg.time_dim + cfg.edge_dim, d),
            fc2=_linear_init(generator, d, d),
            fc1_src=_linear_init(generator, d, d),
            fc2_src=_linear_init(generator, d, d))
    params.update(
        affinity_fc1=_linear_init(generator, 2 * h, h),
        affinity_fc2=_linear_init(generator, h, 1),
        cell=cell_init(generator, cfg.cell_input_dim, cfg.memory_dim))
    params.update(_tower_init(cfg, generator))
    if cfg.message_function == "mlp":
        raw = cfg.message_dim
        params.update(
            msg_fc1=_linear_init(generator, raw, raw // 2, False),
            msg_fc2=_linear_init(generator, raw // 2, cfg.memory_dim, False))
    return nn.ModuleDict(params).to(dev).requires_grad_(False)


def init_seed_params(cfg: Config, device=None,
                     lanes: Optional[Sequence[int]] = None) -> nn.ModuleDict:
    """Seed-parallel parameters: ``init_tgn_params``'s structure with a
    leading axis over the global seed lanes ``lanes`` (all S =
    ``cfg.n_seeds`` by default) on every leaf, lane g drawn as a
    single-seed Trainer with seed ``cfg.seed + g`` draws its own."""
    lanes = range(cfg.n_seeds) if lanes is None else lanes
    return stack_params([
        init_tgn_params(cfg.replace(seed=cfg.seed + g),
                        torch.Generator().manual_seed(cfg.seed + g), "cpu")
        for g in lanes]).to(resolve_device(device))


def stack_params(lanes) -> nn.ModuleDict:
    """Per-seed parameter trees (same structure) → one tree of stacked
    leaves [S, ...]."""
    return nn.ModuleDict({
        name: nn.ParameterDict({
            key: torch.stack([lane[name][key].detach() for lane in lanes])
            for key in layer.keys()})
        for name, layer in lanes[0].items()}).requires_grad_(False)


def lane_params(params, s: int):
    """Lane ``s`` of stacked parameters as a tree of views (plain dicts)."""
    return {name: {key: v[s] for key, v in layer.items()}
            for name, layer in params.items()}


def params_from_state_dict(state) -> nn.ModuleDict:
    """A parameter tree from a ``state_dict()`` (keys ``"fc1.w"``,
    ``"attn_0.merge_fc1_w"`` …), with the shapes the state holds:
    single-seed or stacked."""
    tree: dict = {}
    for key, v in state.items():
        name, leaf = key.split(".")
        tree.setdefault(name, {})[leaf] = v.detach().clone()
    return nn.ModuleDict({name: nn.ParameterDict(layer)
                          for name, layer in tree.items()}).requires_grad_(False)


class BlockMasks(NamedTuple):
    """The dropout masks of a block of a batch's query rows: ``generator``
    draws the masks of all ``n_rows`` rows of the batch, and the block
    keeps its ``rows`` (i64 positions among them, on the activations'
    device)."""

    generator: torch.Generator
    rows: torch.Tensor
    n_rows: int


def _dropout_keep(shape, dropout: float, generator, device,
                  row_axis: int) -> torch.Tensor:
    """The keep mask of inverted dropout. ``generator`` is one generator,
    or a list of one per seed lane: lane s then draws its mask [shape[1:]]
    from its own generator, as a single-seed forward would, and the masks
    are stacked. A :class:`BlockMasks` draws the whole batch's mask, whose
    query rows lie on ``row_axis``, and keeps its block's rows."""
    if isinstance(generator, BlockMasks):
        full = list(shape)
        full[row_axis] = generator.n_rows
        draw = torch.rand(full, generator=generator.generator, device=device)
        return draw.index_select(row_axis, generator.rows) < 1.0 - dropout
    if isinstance(generator, (list, tuple)):
        draw = torch.stack([torch.rand(shape[1:], generator=g, device=device)
                            for g in generator])
    else:
        draw = torch.rand(shape, generator=generator, device=device)
    return draw < 1.0 - dropout


def _mlp2(p1, p2, x, mxu=None, dropout: float = 0.0, generator=None,
          row_axis: int = -2):
    """fc2(drop(relu(fc1(x)))): inverted dropout of rate ``dropout`` with a
    mask from ``generator`` (no dropout when it is None; one generator per
    lane for stacked parameters; ``row_axis`` is the query-row axis of a
    :class:`BlockMasks`)."""
    hidden = torch.relu(add_bias(matmul(x, p1["w"], mxu), p1["b"]))
    if generator is not None and dropout > 0.0:
        keep = _dropout_keep(hidden.shape, dropout, generator, hidden.device,
                             row_axis)
        hidden = torch.where(keep, hidden / (1.0 - dropout), 0.0)
    return add_bias(matmul(hidden, p2["w"], mxu), p2["b"])


def cell_apply(cfg: Config, params, msgs, mem):
    _, apply = CELLS[cfg.memory_updater]
    return apply(params["cell"], msgs, mem, cfg.mxu_dtype)


def message_input(cfg: Config, params, mem, ids, self_rows=None):
    """The updater-cell input for the pending messages of ``ids`` (all rows
    when None) and the pending flags, from one message-row gather: the flag
    is the last message column (``memory.py``). The input is the stored
    last message, or under the ``mean`` aggregator the accumulated sum over
    ``max(msg_count, 1)`` in f32. ``self_rows`` is the caller's gather of
    ``memory[ids]`` (the sender part of the compact layout), gathered here
    when not given."""
    g = (lambda a: a) if ids is None else (lambda a: a[ids])
    rows = g(mem.messages)
    raw = rows[..., :-1]
    if cfg.aggregator == "mean":
        raw = raw.float() / g(mem.msg_count).clamp(min=1.0)[..., None]
    if cfg.compact_messages and self_rows is None:
        self_rows = g(mem.memory)
    cell_in = message_cell_input(cfg, params, raw, self_rows)
    return cell_in, rows[..., -1] != 0


def message_cell_input(cfg: Config, params, raw, self_rows):
    """Updater-cell input from a raw stored message: under the compact
    layout the sender-memory part is re-attached from ``self_rows`` (in the
    promoted dtype of the two, as JAX does: bf16 when both are bf16), then
    the mlp message function, relu(fc1(raw)) → fc2, runs in f32 (stacked
    parameters: one batched product per layer over the lanes)."""
    if cfg.compact_messages:
        dt = torch.promote_types(self_rows.dtype, raw.dtype)
        raw = torch.cat([self_rows.to(dt), raw.to(dt)], dim=-1)
    if cfg.message_function == "mlp":
        p1, p2 = params["msg_fc1"], params["msg_fc2"]
        hidden = torch.relu(add_bias(matmul(raw.float(), p1["w"]), p1["b"]))
        raw = add_bias(matmul(hidden, p2["w"]), p2["b"])
    return raw


def diffusion_static_input(cfg: Config, edge_feats, eidx, dt) -> torch.Tensor:
    """``[edge_feat; time_enc(Δt)]`` → [M, Q, k, De+Dt]. Edge ids past the
    feature table (fresh events a server observes) read the zero row 0."""
    basis = time_basis(cfg.time_dim, edge_feats.device)
    safe = torch.where(eidx < edge_feats.shape[0], eidx, 0)
    return torch.cat([edge_feats[safe], time_encode(dt, basis)], dim=-1)


def diffusion_embed(cfg: Config, params, src_mem: torch.Tensor,
                    nbr_mem: torch.Tensor, nbr_static: torch.Tensor,
                    w: torch.Tensor, generator=None) -> torch.Tensor:
    """Ensemble diffusion embedding → [Q, d·(M+1)]; train mode (dropout at
    ``cfg.dropout``) when a ``generator`` for the masks is given.

    src_mem [Q, d] and nbr_mem [M, Q, k, d] in the memory table's dtype (or
    f32 after a lazy update), nbr_static [M, Q, k, De+Dt] f32, w [M, Q, k]
    T-PPR weights. Stacked parameters take src_mem [S, Q, d] and nbr_mem
    [S, M, Q, k, d] and return [S, Q, d·(M+1)]; nbr_static and w may then
    be per lane or shared by all lanes."""
    src_emb = _mlp2(params["fc1_src"], params["fc2_src"], src_mem,
                    cfg.mxu_dtype, cfg.dropout, generator)
    dt = torch.promote_types(nbr_mem.dtype, nbr_static.dtype)
    nbr_static = nbr_static.expand(nbr_mem.shape[:-1] + nbr_static.shape[-1:])
    nbr_in = torch.cat([nbr_mem.to(dt), nbr_static.to(dt)], dim=-1)
    nbr_emb = _mlp2(params["fc1"], params["fc2"], nbr_in, cfg.mxu_dtype,
                    cfg.dropout, generator, row_axis=-3)

    # weight-normalize with the zero-sum guard
    w_sum = w.sum(-1, keepdim=True)                          # [M, Q, 1]
    w_n = torch.where(w_sum > 0, w / torch.where(w_sum > 0, w_sum, 1.0), 0.0)
    agg = (nbr_emb * w_n[..., None]).sum(-2)                 # [M, Q, d]
    return torch.cat([src_emb] + list(agg.unbind(-3)), dim=-1)


def affinity_score(params, e1: torch.Tensor, e2: torch.Tensor,
                   mxu=None) -> torch.Tensor:
    """MergeLayer link head → logits [B] ([S, B] for stacked
    parameters)."""
    x = torch.cat([e1, e2], dim=-1)
    hidden = torch.relu(add_bias(matmul(x, params["affinity_fc1"]["w"], mxu),
                                 params["affinity_fc1"]["b"]))
    return add_bias(matmul(hidden, params["affinity_fc2"]["w"], mxu),
                    params["affinity_fc2"]["b"])[..., 0]
