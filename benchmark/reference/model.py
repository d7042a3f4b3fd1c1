"""The plain TGN step with the diffusion tower, in PyTorch: towers, GRU
memory updater, link head, BCE loss, Adam, and the train and eval memory
protocols (SURVEY.md rows 11-16, TGN's last-message memory).

- Memory: per node a memory row, its last update time, one pending message
  and its time. Memory and message tables are held in the configuration's
  table type (bfloat16); everything else is float32. A product whose input
  comes straight from a table rounds both operands to bfloat16 and adds in
  float32; other products are float32 with TF32 off.
- Diffusion tower of a query row: fc2_src(drop(relu(fc1_src(mem[v])))) and,
  per ensemble member, the T-PPR-weighted sum of fc2(drop(relu(fc1([mem[u];
  edge_feat; cos(Δt·ω)])))) over its top-k neighbours u (weights normalised
  to sum 1, none where they sum to 0), all concatenated. ω_j = 1/10^{9j/(d-1)}
  in float32.
- Link head fc2(relu(fc1([e_src; e_dst]))); loss BCE(pos, 1) + BCE(neg, 0),
  each a batch mean.
- Train batch: the lazy update first: every distinct selected neighbour
  with a pending message, and every query node among them, reads
  GRU([mem; message], mem) instead of its row, differentiably, without
  committing. Then backward and Adam; then, with the new parameters, the
  positives' pending messages commit, and the batch's messages (both
  directions, the last per sender) are stored from the committed memory:
  [mem[receiver]; edge_feat; cos((t − last_update[sender])·ω)].
- Eval batch (``observe``): the batch's messages built from the memory
  before it, the last per sender committed at once.
- Dropout (train) keeps an activation with probability 1 − p, scaled by
  1/(1 − p), with masks drawn per batch from the seed's generator: the
  source MLP's [Q, d] mask, then the neighbour MLP's [M, Q, k, d].

``Prec(low=True)`` is the control: every product in bfloat16, the tables
in float8 (e4m3), the index weights in bfloat16 (``santa.Index(low=True)``).
This module imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Dims(NamedTuple):
    d: int          # node, memory width
    t: int          # time encoding width
    e: int          # edge feature width
    m: int          # ensemble members
    k: int          # top-k

    @property
    def h(self) -> int:
        return self.d * (self.m + 1)

    @property
    def msg(self) -> int:
        """Raw message: [mem sender; mem receiver; edge feat; time enc]."""
        return 2 * self.d + self.e + self.t


def layout(dims: Dims) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every parameter: (name, shape, law, scale). Laws: ``normal`` with
    std ``scale`` (Xavier for the linear layers), ``uniform`` on
    ±``scale``."""
    d, h = dims.d, dims.h
    out = []

    def linear(name, n_in, n_out):
        out.append((f"{name}.w", (n_in, n_out), "normal",
                    (2.0 / (n_in + n_out)) ** 0.5))
        out.append((f"{name}.b", (n_out,), "uniform", n_in ** -0.5))

    linear("fc1", d + dims.t + dims.e, d)
    linear("fc2", d, d)
    linear("fc1_src", d, d)
    linear("fc2_src", d, d)
    linear("affinity_fc1", 2 * h, h)
    linear("affinity_fc2", h, 1)
    for name, shape in (("w_ih", (dims.msg, 3 * d)), ("w_hh", (d, 3 * d)),
                        ("b_ih", (3 * d,)), ("b_hh", (3 * d,))):
        out.append((f"cell.{name}", shape, "uniform", d ** -0.5))
    return out


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Prec:
    """The precision of a run of the reference: the configuration's
    (``low=False``) or the control's."""

    def __init__(self, low: bool = False):
        self.low = low
        self.table = torch.float8_e4m3fn if low else torch.bfloat16

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """A value as a table holds it (as float32)."""
        return x.to(self.table).float()

    def mm(self, x, w, from_table: bool = False) -> torch.Tensor:
        if self.low or from_table:
            x, w = bf16(x), bf16(w)
        return x @ w


def time_basis(dim: int, device) -> torch.Tensor:
    basis = 1.0 / 10.0 ** np.linspace(0, 9, dim, dtype=np.float32)
    return torch.from_numpy(np.asarray(basis, np.float32)).to(device)


def gru(p, prec: Prec, x, h) -> torch.Tensor:
    """GRU cell (torch gate order r, z, n) on table inputs."""
    n = h.shape[-1]
    gi = prec.mm(x, p["cell.w_ih"], True) + p["cell.b_ih"]
    gh = prec.mm(h, p["cell.w_hh"], True) + p["cell.b_hh"]
    r = torch.sigmoid(gi[..., :n] + gh[..., :n])
    z = torch.sigmoid(gi[..., n: 2 * n] + gh[..., n: 2 * n])
    c = torch.tanh(gi[..., 2 * n:] + r * gh[..., 2 * n:])
    return (1.0 - z) * c + z * h


def mlp2(p, prec: Prec, a: str, b: str, x, from_table=False, keep=None,
         rate: float = 0.0):
    hidden = torch.relu(prec.mm(x, p[f"{a}.w"], from_table) + p[f"{a}.b"])
    if keep is not None:
        hidden = torch.where(keep, hidden / (1.0 - rate), 0.0)
    return prec.mm(hidden, p[f"{b}.w"]) + p[f"{b}.b"]


class Queries(NamedTuple):
    """T-PPR answers of Q query rows, fields [M, Q, k]."""

    nbr: torch.Tensor
    eidx: torch.Tensor
    dt: torch.Tensor
    w: torch.Tensor


def embed(p, prec: Prec, src_rows, src_from_table: bool, nbr_rows,
          q: Queries, feats, basis, masks=None, rate: float = 0.0):
    """Diffusion embeddings [Q, d·(M+1)]; ``masks`` (keep masks of the two
    MLPs) in train mode."""
    ms, mn = masks if masks is not None else (None, None)
    src_emb = mlp2(p, prec, "fc1_src", "fc2_src", src_rows, src_from_table,
                   ms, rate)
    static = torch.cat([feats[q.eidx], torch.cos(q.dt[..., None] * basis)],
                       -1)
    nbr_emb = mlp2(p, prec, "fc1", "fc2", torch.cat([nbr_rows, static], -1),
                   False, mn, rate)
    w_sum = q.w.sum(-1, keepdim=True)
    w_n = torch.where(w_sum > 0, q.w / torch.where(w_sum > 0, w_sum, 1.0), 0.0)
    agg = (nbr_emb * w_n[..., None]).sum(-2)
    return torch.cat([src_emb] + list(agg.unbind(0)), -1)


def head(p, prec: Prec, e1, e2) -> torch.Tensor:
    hidden = torch.relu(prec.mm(torch.cat([e1, e2], -1),
                                p["affinity_fc1.w"]) + p["affinity_fc1.b"])
    return (prec.mm(hidden, p["affinity_fc2.w"]) + p["affinity_fc2.b"])[..., 0]


class Memory:
    """Memory, last update, pending message, its flag and time, per node."""

    def __init__(self, n: int, dims: Dims, device):
        z = lambda *s: torch.zeros(s, device=device)
        self.memory = z(n, dims.d)
        self.last = z(n)
        self.msg = z(n, dims.msg - dims.d)
        self.flag = torch.zeros(n, dtype=torch.bool, device=device)
        self.msg_ts = z(n)

    def messages(self, feats, basis, prec: Prec, src, dst, t, eidx):
        """The batch's messages, both directions, as a table holds them,
        and the last position of each sender: (senders, times, rows,
        winner positions)."""
        snd, rcv = torch.cat([src, dst]), torch.cat([dst, src])
        t2, e2 = torch.cat([t, t]), torch.cat([eidx, eidx])
        raw = torch.cat([self.memory[rcv], feats[e2],
                         torch.cos((t2 - self.last[snd])[:, None] * basis)],
                        -1)
        pos = torch.arange(len(snd), device=snd.device)
        last = torch.full((self.memory.shape[0],), -1, dtype=torch.long,
                          device=snd.device)
        last.scatter_reduce_(0, snd, pos, "amax")
        win = torch.unique(last[snd])
        return snd, t2, prec.store(raw), win

    def observe(self, p, prec: Prec, feats, basis, src, dst, t, eidx):
        """The eval protocol of a batch."""
        snd, t2, raw, win = self.messages(feats, basis, prec, src, dst, t,
                                          eidx)
        s = snd[win]
        rows = self.memory[s]
        self.memory[s] = prec.store(gru(p, prec, torch.cat([rows, raw[win]],
                                                           -1), rows))
        self.last[s] = t2[win]
        self.msg_ts[s] = t2[win]
        self.msg[s] = 0.0
        self.flag[s] = False

    def lazy(self, p, prec: Prec, nodes, nbr):
        """(query rows, neighbour rows) of the lazy update."""
        sel = torch.unique(nbr)
        rows = self.memory[sel]
        upd = gru(p, prec, torch.cat([rows, self.msg[sel]], -1), rows)
        rows = torch.where(self.flag[sel][:, None], upd, rows)
        table = self.memory.index_put((sel,), rows)
        return table[nodes], table[nbr]

    def train_protocol(self, p, prec: Prec, feats, basis, src, dst, t, eidx):
        """Commit the positives' pending messages, then store the batch's."""
        pos = torch.cat([src, dst])
        rows, pend = self.memory[pos], self.flag[pos]
        upd = prec.store(gru(p, prec, torch.cat([rows, self.msg[pos]], -1),
                             rows))
        self.memory[pos] = torch.where(pend[:, None], upd, rows)
        self.last[pos] = torch.where(pend, self.msg_ts[pos], self.last[pos])
        self.msg[pos] = 0.0
        self.flag[pos] = False
        snd, t2, raw, win = self.messages(feats, basis, prec, src, dst, t,
                                          eidx)
        s = snd[win]
        self.msg[s] = raw[win]
        self.flag[s] = True
        self.msg_ts[s] = t2[win]


def dropout_masks(gen: torch.Generator, q: int, dims: Dims, rate: float,
                  device):
    """One batch's keep masks: the source MLP's, then the neighbours'."""
    keep = lambda *s: torch.rand(s, generator=gen, device=device) < 1.0 - rate
    return keep(q, dims.d), keep(dims.m, q, dims.k, dims.d)


class Adam:
    """Adam (β 0.9, 0.999, ε 1e-8) with bias correction, per leaf."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.t += 1
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].lerp_(g, 1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / (bc2 ** 0.5) + eps
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


class Step(NamedTuple):
    loss: float
    grads: Optional[Dict[str, torch.Tensor]]


def train_steps(params: Dict[str, torch.Tensor], prec: Prec, dims: Dims,
                lr: float, rate: float, gen: torch.Generator, n_nodes: int,
                feats, batches: Sequence[dict]
                ) -> Tuple[List[Step], Memory, Dict[str, torch.Tensor]]:
    """Train batches from zeroed memory. Each batch: ``src``, ``dst``,
    ``neg``, ``t``, ``eidx`` [b] and queries ``q`` ([M, 3b, k] in src‖dst‖neg
    order). Returns each step's loss (and the first's gradients), the
    memory after the last batch but one's protocol (as it is when the last
    batch's Adam step ends), and the parameters after the last step."""
    dev = feats.device
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = Adam(params, lr)
    mem = Memory(n_nodes, dims, dev)
    basis = time_basis(dims.t, dev)
    steps, before_last = [], None
    for i, bt in enumerate(batches):
        b = len(bt["src"])
        nodes = torch.cat([bt["src"], bt["dst"], bt["neg"]])
        q = bt["q"]
        src_rows, nbr_rows = mem.lazy(params, prec, nodes, q.nbr)
        masks = dropout_masks(gen, len(nodes), dims, rate, dev) if rate else None
        emb = embed(params, prec, src_rows, False, nbr_rows, q, feats, basis,
                    masks, rate)
        logits = head(params, prec, torch.cat([emb[:b], emb[:b]]),
                      torch.cat([emb[b: 2 * b], emb[2 * b:]]))
        loss = (F.binary_cross_entropy_with_logits(
                    logits[:b], torch.ones_like(logits[:b]))
                + F.binary_cross_entropy_with_logits(
                    logits[b:], torch.zeros_like(logits[b:])))
        grads = dict(zip(params, torch.autograd.grad(loss, list(
            params.values()))))
        opt.step(params, grads)
        steps.append(Step(float(loss.detach()), grads if i == 0 else None))
        if i == len(batches) - 1:
            before_last = mem
            break
        with torch.no_grad():
            mem.train_protocol(params, prec, feats, basis, bt["src"],
                               bt["dst"], bt["t"], bt["eidx"])
    final = {k: v.detach() for k, v in params.items()}
    return steps, before_last, final


def score(params, prec: Prec, dims: Dims, mem: Memory, feats, basis,
          q: Queries, src, dst) -> torch.Tensor:
    """Link probabilities of candidates (src, dst) with their queries
    ([M, 2B, k], src‖dst)."""
    nodes = torch.cat([src, dst])
    with torch.no_grad():
        emb = embed(params, prec, mem.memory[nodes], True, mem.memory[q.nbr],
                    q, feats, basis)
        b = len(src)
        return torch.sigmoid(head(params, prec, emb[:b], emb[b:]))
