"""The plain TGN step with the recursive temporal graph attention tower, in
PyTorch (Rossi et al., arXiv:2006.10637; github.com/twitter-research/tgn,
``modules/embedding_module.py:GraphAttentionEmbedding``,
``model/temporal_attention.py``): the most recent neighbours, the hop
tree, the lazy GRU, the attention layers, the link head, BCE loss, Adam and
the train memory protocol.

- Neighbours: each node's interactions (both directions of every train
  event) in stream order, a plain list per node. A node's ``n`` most recent
  neighbours before a cut are the last ``n`` entries of its list whose
  float32 time lies strictly below the float32 cut, newest first; missing
  ones are padding (node 0, edge 0, time 0, not valid).
- Hop tree: level 0 holds the roots at their times; level l the ``n`` most
  recent neighbours of every node of level l − 1 at that node's time (a
  root's event time, a neighbour's edge time), padding slots included, in
  parent-major order.
- Rows: every node of every level reads its memory row, passed through the
  GRU where a message is pending (train mode), without committing.
- Layer l (l = 1 … L, deepest first; parameters ``attn_{l-1}``) embeds each
  node of level L − l from its row and its children's embeddings (level L's
  are their rows): query [row; cos(0·ω)], keys and values [child; edge
  feature; cos((t_parent − t_child)·ω)], ``n_head`` heads of scaled dot
  products, padding masked out (a node with no valid child unmasks slot 0
  and its attention output is zeroed), the output projection, then the
  MergeLayer fc2(relu(fc1([attention output; row]))). ω is the fixed basis
  of ``model.time_basis``. Edge ids past the feature table read its last
  row.
- Link head, loss, Adam and the protocol: ``model.head``, BCE(pos, 1) +
  BCE(neg, 0), ``model.Adam``, ``model.Memory.train_protocol``; from
  zeroed memory (``train_steps``), or one batch from a given state
  (``step_from``).

Departures from TGN's code that the program shares: ω is fixed (TGN learns
ω and a bias), node features are zero (the embedding's input is the memory
row alone), and the attention applies no dropout (TGN: 0.1 on the
attention weights).

Tables and products are float32 with TF32 off. ``Prec(low=True)`` is the
control: every product in bfloat16 (operands rounded, sums in float32) and
the tables in bfloat16. This module imports nothing of the program."""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import (
    Adam,
    Dims,
    Memory,
    Step,
    bf16,
    gru,
    head,
    time_basis,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Prec:
    """The precision of a run: float32 tables and products, or the
    control's bfloat16 for both."""

    def __init__(self, low: bool = False):
        self.low = low
        self.table = torch.bfloat16 if low else torch.float32

    def store(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.table).float()

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as the product takes it."""
        return bf16(x) if self.low else x

    def mm(self, x, w, from_table: bool = False) -> torch.Tensor:
        return self.r(x) @ self.r(w)


def dims(d: int, t: int, e: int, n: int) -> Dims:
    """The model's widths: ``m`` = 0 makes the head's width ``d``."""
    return Dims(d=d, t=t, e=e, m=0, k=n)


def layout(dm: Dims, n_layer: int) -> List[Tuple[str, Tuple[int, ...], str,
                                                 float]]:
    """Every parameter: (name, shape, law, scale), Xavier-normal weights
    and U(±1/√in) biases, the GRU's U(±1/√d)."""
    d = dm.d
    q, k = d + dm.t, d + dm.e + dm.t
    out = []

    def linear(w, b, n_in, n_out):
        out.append((w, (n_in, n_out), "normal", (2.0 / (n_in + n_out)) ** 0.5))
        out.append((b, (n_out,), "uniform", n_in ** -0.5))

    for l in range(n_layer):
        a = f"attn_{l}"
        linear(f"{a}.w_q", f"{a}.b_q", q, q)
        linear(f"{a}.w_k", f"{a}.b_k", k, q)
        linear(f"{a}.w_v", f"{a}.b_v", k, q)
        linear(f"{a}.w_o", f"{a}.b_o", q, q)
        linear(f"{a}.merge_fc1_w", f"{a}.merge_fc1_b", q + d, d)
        linear(f"{a}.merge_fc2_w", f"{a}.merge_fc2_b", d, d)
    linear("affinity_fc1.w", "affinity_fc1.b", 2 * d, d)
    linear("affinity_fc2.w", "affinity_fc2.b", d, 1)
    for name, shape in (("w_ih", (dm.msg, 3 * d)), ("w_hh", (d, 3 * d)),
                        ("b_ih", (3 * d,)), ("b_hh", (3 * d,))):
        out.append((f"cell.{name}", shape, "uniform", d ** -0.5))
    return out


# ------------------------------------------------------------ neighbours

class Adjacency:
    """Each node's interactions in stream order: (neighbour, edge id,
    float32 time) per entry, one array each per node."""

    def __init__(self, src, dst, t, eidx, n_nodes: int):
        lists: List[list] = [[] for _ in range(n_nodes)]
        t32 = np.asarray(t, np.float32)
        for s, d, ts, e in zip(np.asarray(src).tolist(),
                               np.asarray(dst).tolist(), t32.tolist(),
                               np.asarray(eidx).tolist()):
            lists[s].append((d, e, ts))
            lists[d].append((s, e, ts))
        self.nodes = [(np.array([x[0] for x in ls], np.int64),
                       np.array([x[1] for x in ls], np.int64),
                       np.array([x[2] for x in ls], np.float32))
                      for ls in lists]

    def recent(self, v: int, cut: np.float32, n: int):
        """(nbr, eidx, ts, valid), each [n], newest first."""
        nbr, eidx, ts = self.nodes[v]
        before = np.flatnonzero(ts < cut)[::-1][:n]
        out = (np.zeros(n, np.int64), np.zeros(n, np.int64),
               np.zeros(n, np.float32), np.zeros(n, bool))
        m = len(before)
        out[0][:m], out[1][:m], out[2][:m] = nbr[before], eidx[before], \
            ts[before]
        out[3][:m] = True
        return out


class Level(NamedTuple):
    """One level of the hop tree: ``nodes`` and ``times`` [Q_l]; below the
    roots also the edge and validity of each slot, [Q_{l-1}, n]."""

    nodes: np.ndarray
    times: np.ndarray
    eidx: np.ndarray = None
    valid: np.ndarray = None


def hop_tree(adj: Adjacency, roots, times, n: int, n_layer: int
             ) -> List[Level]:
    tree = [Level(np.asarray(roots, np.int64),
                  np.asarray(times, np.float32))]
    for _ in range(n_layer):
        got = [adj.recent(int(v), np.float32(c), n)
               for v, c in zip(tree[-1].nodes, tree[-1].times)]
        nbr, eidx, ts, valid = (np.stack([g[i] for g in got])
                                for i in range(4))
        tree.append(Level(nbr.reshape(-1), ts.reshape(-1), eidx, valid))
    return tree


def tree_gap(ref: Sequence[Level], got: Sequence[Level]) -> float:
    """The share of slots (over every level below the roots) whose
    neighbour, edge id, time or validity differs; 1 where the shapes
    differ."""
    bad = total = 0
    for r, g in zip(ref[1:], got[1:]):
        if r.valid.shape != np.shape(g.valid):
            return 1.0
        q, n = r.valid.shape
        diff = (r.valid != g.valid)
        for a, b in ((r.nodes, g.nodes), (r.times, g.times),
                     (r.eidx.reshape(-1), np.reshape(g.eidx, -1))):
            diff = diff | (np.asarray(a).reshape(q, n)
                           != np.asarray(b).reshape(q, n))
        bad += int(diff.sum())
        total += diff.size
    return bad / max(total, 1)


# ---------------------------------------------------------------- the tower

def attention(p, prec: Prec, a: str, src, nbr, te_src, te_nbr, ef, valid,
              n_head: int) -> torch.Tensor:
    """One layer: ``src`` [Q, d], ``nbr`` [Q, n, d], ``te_src`` [Dt],
    ``te_nbr`` [Q, n, Dt], ``ef`` [Q, n, De], ``valid`` [Q, n] → [Q, d]."""
    qn, n = valid.shape
    query = torch.cat([src, te_src.expand(qn, -1)], -1)
    keys = torch.cat([nbr, ef, te_nbr], -1)
    q = prec.mm(query, p[f"{a}.w_q"]) + p[f"{a}.b_q"]
    k = prec.mm(keys, p[f"{a}.w_k"]) + p[f"{a}.b_k"]
    v = prec.mm(keys, p[f"{a}.w_v"]) + p[f"{a}.b_v"]
    hd = q.shape[-1] // n_head
    q = q.reshape(qn, 1, n_head, hd)
    k = k.reshape(qn, n, n_head, hd)
    v = v.reshape(qn, n, n_head, hd)
    score = (prec.r(q) * prec.r(k)).sum(-1) / math.sqrt(hd)  # [Q, n, h]
    none = ~valid.any(-1)
    mask = valid.clone()
    mask[:, 0] |= none
    score = score.masked_fill(~mask[..., None], float("-inf"))
    w = torch.softmax(score, dim=1)
    out = (prec.r(w)[..., None] * prec.r(v)).sum(1).reshape(qn, -1)
    out = prec.mm(out, p[f"{a}.w_o"]) + p[f"{a}.b_o"]
    out = torch.where(none[:, None], 0.0, out)
    hidden = torch.relu(prec.mm(torch.cat([out, src], -1),
                                p[f"{a}.merge_fc1_w"]) + p[f"{a}.merge_fc1_b"])
    return prec.mm(hidden, p[f"{a}.merge_fc2_w"]) + p[f"{a}.merge_fc2_b"]


def lazy(p, prec: Prec, mem: Memory, ids: torch.Tensor) -> torch.Tensor:
    """Memory rows of ``ids``, through the GRU where a message is
    pending."""
    rows = mem.memory[ids]
    upd = gru(p, prec, torch.cat([rows, mem.msg[ids]], -1), rows)
    return torch.where(mem.flag[ids][:, None], upd, rows)


def embed(p, prec: Prec, mem: Memory, tree: Sequence[Level], feats, basis,
          n_head: int, train: bool) -> torch.Tensor:
    """The roots' embeddings [Q_0, d]."""
    dev = feats.device
    t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    rows = []
    for lv in tree:
        ids = t(lv.nodes, torch.long)
        rows.append(lazy(p, prec, mem, ids) if train else mem.memory[ids])
    emb = rows[-1]
    last = feats.shape[0] - 1
    depth = len(tree) - 1
    for lvl in range(depth - 1, -1, -1):
        parent, child = tree[lvl], tree[lvl + 1]
        qn, n = child.valid.shape
        dt = (t(parent.times, torch.float32)[:, None]
              - t(child.times, torch.float32).reshape(qn, n))
        ef = feats[t(child.eidx, torch.long).clamp(max=last)]
        emb = attention(p, prec, f"attn_{depth - 1 - lvl}", rows[lvl],
                        emb.reshape(qn, n, -1), torch.cos(0.0 * basis),
                        torch.cos(dt[..., None] * basis), ef,
                        t(child.valid, torch.bool), n_head)
    return emb


def link_loss(p, prec: Prec, emb: torch.Tensor, b: int) -> torch.Tensor:
    """BCE(pos, 1) + BCE(neg, 0) of the roots' embeddings src‖dst‖neg."""
    logits = head(p, prec, torch.cat([emb[:b], emb[:b]]),
                  torch.cat([emb[b: 2 * b], emb[2 * b:]]))
    return (F.binary_cross_entropy_with_logits(
                logits[:b], torch.ones_like(logits[:b]))
            + F.binary_cross_entropy_with_logits(
                logits[b:], torch.zeros_like(logits[b:])))


def memory_of(prec: Prec, dm: Dims, memory, last, messages, msg_ts
              ) -> Memory:
    """A ``Memory`` holding a given state, as its tables store it: the
    memory rows, their last update, the pending messages (rows of the
    receiver's memory, edge feature and time encoding, and a last column
    that flags them) and their times."""
    mem = Memory(len(memory), dm, memory.device)
    mem.memory = prec.store(memory.float()).clone()
    mem.last = last.float().clone()
    mem.msg = prec.store(messages[:, :-1].float()).clone()
    mem.flag = messages[:, -1] != 0
    mem.msg_ts = msg_ts.float().clone()
    return mem


def step_from(params, params_next, prec: Prec, dm: Dims, n_head: int,
              mem: Memory, feats, batch: dict) -> Tuple[torch.Tensor, float]:
    """One train batch from a given state, without autograd: the roots'
    embeddings and the loss under ``params``, then the batch's protocol
    under ``params_next`` (the parameters its Adam step left), in place on
    ``mem``."""
    basis = time_basis(dm.t, feats.device)
    with torch.no_grad():
        emb = embed(params, prec, mem, batch["tree"], feats, basis, n_head,
                    True)
        loss = float(link_loss(params, prec, emb, len(batch["src"])))
        mem.train_protocol(params_next, prec, feats, basis, batch["src"],
                           batch["dst"], batch["t"], batch["eidx"])
    return emb, loss


def train_steps(params: Dict[str, torch.Tensor], prec: Prec, dm: Dims,
                n_head: int, lr: float, n_nodes: int, feats,
                batches: Sequence[dict], embs: Optional[list] = None
                ) -> Tuple[List[Step], Memory, Dict[str, torch.Tensor]]:
    """Train batches from zeroed memory. Each batch: ``src``, ``dst``,
    ``neg``, ``t``, ``eidx`` [b] and ``tree``, the hop tree of the roots
    src‖dst‖neg. Returns each step's loss (and the first's gradients), the
    memory after the last batch but one's protocol (as it is when the last
    batch's Adam step ends), and the parameters after the last step.
    ``embs``, a list, receives each step's root embeddings."""
    dev = feats.device
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = Adam(params, lr)
    mem = Memory(n_nodes, dm, dev)
    basis = time_basis(dm.t, dev)
    steps = []
    for i, bt in enumerate(batches):
        b = len(bt["src"])
        emb = embed(params, prec, mem, bt["tree"], feats, basis, n_head, True)
        if embs is not None:
            embs.append(emb.detach())
        loss = link_loss(params, prec, emb, b)
        grads = dict(zip(params, torch.autograd.grad(loss, list(
            params.values()))))
        opt.step(params, grads)
        steps.append(Step(float(loss.detach()), grads if i == 0 else None))
        if i == len(batches) - 1:
            break
        with torch.no_grad():
            mem.train_protocol(params, prec, feats, basis, bt["src"],
                               bt["dst"], bt["t"], bt["eidx"])
    final = {k: v.detach() for k, v in params.items()}
    return steps, mem, final
