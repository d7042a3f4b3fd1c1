"""Downstream node classification on the link-trained model (counterpart of
``zebra_tpu/train/node_classification.py``, the CLI's ``--task node``).

1. :func:`collect_source_embeddings`: an eval-mode replay of a stream (the
   evaluation protocol for memory and index) that emits each event's
   source embedding. Destinations stand in the negative slot, as in the
   reference's call. The streaming index runs through the Trainer's wave
   path (``plan_waves`` + ``wave_scan_chunk``: one ``santa_waves`` launch
   per superchunk on the card); under the pruning strategy each batch's src‖dst
   roots take one BFS over an adjacency index. The towers other than
   diffusion read no T-PPR query: the recursive ones search the adjacency
   index at the events' times. Each batch's memory protocol stores then
   commits, as JAX's replay does, with the batch's src and dst embeddings
   in the messages under a message-source flag.
2. :class:`NodeDecoder`: the reference head dim → 80 → 10 → 1 with dropout.
3. :func:`train_node_classifier` (Adam and BCE) and
   :func:`eval_node_classification` (pairwise ROC-AUC).
4. :func:`run_node_classification`: the protocol over a Trainer."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.index.layout import TpprParams
from zebra_tpu_torch.index.neighbor_finder import NeighborIndex
from zebra_tpu_torch.index.queries import (
    batch_queries,
    ensemble_tensors,
    pruned_queries,
)
from zebra_tpu_torch.index.streaming import TpprQueries, TpprState
from zebra_tpu_torch.index.waves import plan_waves, wave_scan_chunk
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.train.step import (
    Stream,
    _forward,
    eval_store_then_commit,
)

DECODER_DROPOUT = 0.3


@torch.no_grad()
def collect_source_embeddings(cfg: Config, params, mem: MemoryState,
                              index_state: Optional[TpprState], edge_feats,
                              ps, nbr_index: Optional[NeighborIndex] = None
                              ) -> Tuple[MemoryState, Optional[TpprState],
                                         torch.Tensor, int]:
    """Eval-mode replay of the phase stream ``ps`` (a Trainer's
    ``PhaseStream``) from (``mem``, ``index_state``), both updated in
    place; where no T-PPR index is kept ``index_state`` is None, and the
    pruning BFS or a recursive tower searches ``nbr_index``. Returns them,
    the source embeddings [padded events, H] f32 in stream order, and the
    index waves run."""
    tppr = TpprParams.create(cfg.alpha_list, cfg.beta_list, cfg.topk)
    bfs = cfg.uses_tppr and not cfg.keeps_tppr_index
    if bfs:
        alpha_beta = ensemble_tensors(cfg, edge_feats.device)
    host, b = ps.host, cfg.bs
    chunk = len(host["src"]) // ps.n_chunks
    n_valid = ps.n_valid().tolist()
    out, waves = [], 0
    for lo in range(0, len(host["src"]), chunk):
        sl = slice(lo, lo + chunk)
        cs = Stream(*(x[sl] for x in ps.stream))
        if cfg.keeps_tppr_index:
            plan = plan_waves(host["src"][sl], host["dst"][sl],
                              host["dst"][sl], host["valid"][sl], cfg.n_nodes,
                              cfg.wave_cap, edge_feats.device)
            index_state, rows = wave_scan_chunk(
                index_state, tppr, cs.src, cs.dst, cs.dst, cs.t, cs.eidx,
                cs.valid, plan)
            waves += plan.n_waves
        for j in range(chunk // b):
            s = Stream(*(x[j * b: (j + 1) * b] for x in cs))
            # the neg slot duplicates dst: embed src‖dst only
            q = None
            if cfg.keeps_tppr_index:
                q = batch_queries(cfg, rows[j * b: (j + 1) * b], s.t)
                q = TpprQueries(*(x[:, : 2 * b] for x in q))
            elif bfs:
                q = pruned_queries(cfg, nbr_index, alpha_beta,
                                   [s.src, s.dst], s.t)
            times = None if cfg.uses_tppr else torch.cat([s.t, s.t])
            emb = _forward(cfg, params, mem, edge_feats,
                           torch.cat([s.src, s.dst]), q, times=times,
                           nbr_index=nbr_index)
            nv = n_valid[(lo + j * b) // b]
            src_emb, dst_emb = ((emb[:b], emb[b:]) if cfg.need_emb
                                else (None, None))
            eval_store_then_commit(cfg, params, mem, edge_feats, s.src, s.dst,
                                   s.t, s.eidx, None if nv == b else s.valid,
                                   None, src_emb, dst_emb)
            # the identity tower's eval rows keep the table's dtype
            out.append(emb[:b].float())
    return mem, index_state, torch.cat(out), waves


# ------------------------------------------------------------------ decoder

def _linear(generator: torch.Generator, d_in: int,
            d_out: int) -> nn.ParameterDict:
    """U(±1/√in) weight [in, out] and bias, as the JAX head draws them."""
    bound = d_in ** -0.5
    u = lambda *shape: (torch.rand(shape, generator=generator) * 2 - 1) * bound
    return nn.ParameterDict({"w": u(d_in, d_out), "b": u(d_out)})


class NodeDecoder(nn.Module):
    """The reference head: dim → 80 → 10 → 1, ReLU, dropout after each
    hidden layer; weights in JAX's [in, out] layout (``fc1``/``fc2``/
    ``fc3`` with ``w``, ``b``)."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.fc1 = _linear(generator, dim, 80)
        self.fc2 = _linear(generator, 80, 10)
        self.fc3 = _linear(generator, 10, 1)

    def forward(self, x: torch.Tensor, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [n]; inverted dropout of rate ``dropout`` with masks from
        ``generator`` (none when it is None)."""
        def drop(h):
            if generator is None or dropout <= 0.0:
                return h
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) < 1.0 - dropout
            return torch.where(keep, h / (1.0 - dropout), 0.0)

        h = drop(torch.relu(x @ self.fc1["w"] + self.fc1["b"]))
        h = drop(torch.relu(h @ self.fc2["w"] + self.fc2["b"]))
        return (h @ self.fc3["w"] + self.fc3["b"])[..., 0]


def decoder_step(decoder: NodeDecoder, optimizer, x, y,
                 dropout: float = DECODER_DROPOUT,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One Adam step on the mean BCE of ``decoder(x)`` against ``y``;
    returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = F.binary_cross_entropy_with_logits(decoder(x, dropout, generator),
                                              y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_node_classifier(embs: torch.Tensor, labels: torch.Tensor,
                          seed: int = 0, n_steps: int = 200, lr: float = 1e-3,
                          batch: int = 1024,
                          dropout: float = DECODER_DROPOUT) -> NodeDecoder:
    """Fit a :class:`NodeDecoder` on ``embs`` [n, H] against ``labels`` [n]
    in {0, 1}: ``n_steps`` Adam steps on batches drawn with replacement.
    The init draws from a CPU generator seeded ``seed``; the batches and
    dropout masks from one on the embeddings' device."""
    decoder = NodeDecoder(embs.shape[-1],
                          torch.Generator().manual_seed(seed)).to(embs.device)
    optimizer = torch.optim.Adam(decoder.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(embs.device).manual_seed(seed)
    n = embs.shape[0]
    for _ in range(n_steps):
        idx = torch.randint(0, n, (min(batch, n),), generator=gen,
                            device=embs.device)
        decoder_step(decoder, optimizer, embs[idx], labels[idx], dropout, gen)
    return decoder


def pairwise_auc(probs: torch.Tensor, labels: torch.Tensor) -> float:
    """P(a positive outscores a negative) + ½ P(tie) over all
    (positive, negative) pairs, counted by binary search in the sorted
    negatives; nan without both classes."""
    pos, neg = probs[labels > 0.5], probs[labels <= 0.5]
    if pos.numel() == 0 or neg.numel() == 0:
        return float("nan")
    neg = torch.sort(neg).values
    below = torch.searchsorted(neg, pos)                 # negatives < p
    upto = torch.searchsorted(neg, pos, right=True)      # negatives ≤ p
    gt = float(below.sum())
    eq = float((upto - below).sum())
    return (gt + 0.5 * eq) / (pos.numel() * neg.numel())


@torch.no_grad()
def eval_node_classification(decoder: NodeDecoder, embs: torch.Tensor,
                             labels: torch.Tensor) -> float:
    """ROC-AUC of the decoder's probabilities against the event labels."""
    return pairwise_auc(torch.sigmoid(decoder(embs)), labels)


def run_node_classification(trainer, n_steps: int = 500, lr: float = 1e-3,
                            seed: int = 0) -> dict:
    """The downstream protocol over a link-trained port ``Trainer``: one
    fresh chronological replay of train → val → test with the trained
    params in eval mode, emitting each event's source embedding; the
    decoder is fit on the train stream's embeddings against the event
    labels and scored by ROC-AUC on all three streams. The replay's index
    waves count into ``trainer.index_waves`` and its superchunks, each
    scanned in one piece, into ``trainer.index_scans``; under the pruning
    strategy, and for the recursive towers, the replay queries the train
    graph on the train stream and the full graph on the val and test
    streams. A
    row-sharded Trainer replays on every rank at full N from fresh tables,
    as JAX's replay runs on one device whatever the mesh: the same waves
    as one process, no exchange, the rank's (permuted, under the
    interleave) streams and replicated params, so every rank returns the
    same AUCs. A seed-parallel Trainer is refused: the decoder consumes one
    model's embeddings."""
    cfg = trainer.cfg
    if cfg.n_seeds > 1:
        raise ValueError(
            "node classification runs on a single-seed Trainer — slice one "
            "seed first (serve.LinkPredictor.from_checkpoint(run_index=...) "
            "semantics)")
    # a row-sharded Trainer's ranks each replay at full N in one process,
    # with the replicated params: every rank computes the same AUCs
    mem, index_state = trainer._fresh_state(whole=True)
    nbr_index = {"train": trainer.train_nbr_index,
                 "val": trainer.full_nbr_index,
                 "test": trainer.full_nbr_index}
    embs, labels = {}, {}
    for name in ("train", "val", "test"):
        data = getattr(trainer.splits, name)
        mem, index_state, e, waves = collect_source_embeddings(
            cfg, trainer.params, mem, index_state, trainer.edge_feats,
            trainer._streams[name], nbr_index[name])
        trainer.index_waves += waves
        if cfg.keeps_tppr_index:
            trainer.index_scans += trainer._streams[name].n_chunks
        embs[name] = e[: data.n_interactions]   # padding trails the events
        labels[name] = torch.as_tensor(data.labels, dtype=torch.float32,
                                       device=trainer.device)
    decoder = train_node_classifier(embs["train"], labels["train"], seed,
                                    n_steps=n_steps, lr=lr)
    return {f"node_{name}_auc": eval_node_classification(
                decoder, embs[name], labels[name])
            for name in ("train", "val", "test")}
