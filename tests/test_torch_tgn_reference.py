"""The port's graph-attention tower (TGN) against the plain reference of the
benchmark (``benchmark/reference/tgn.py``, plain torch, f32, nothing of the
port) on seeded random weights: a Trainer's first superchunk of a small
stream, its first three train steps recorded, at 1 and 2 hops.

Compared: the hop trees exactly (neighbour, edge id, time, valid flag),
the roots' embeddings, the losses, the first gradient, and the memory and
the parameters after the third step. Each tolerance is checked in both
directions: the port lies within it, and the reference computed in
bfloat16 products and tables (the control) lies outside it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import checks, program, streams, weights_tgn
from benchmark.reference import tgn
from benchmark.weights import edge_features
from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.train.loop import Trainer

SEED, STEPS, BS, DIM, EDGE, N = 11, 3, 50, 16, 8, 4

# Each tolerance with its reason. The port and the reference run the same
# f32 operations in other orders and groupings (einsum against a
# broadcast sum, one GRU over a level against one over its rows), so they
# part by f32 round-off, a few 1e-7 relative, grown by what follows:
TOL = dict(
    # two attention layers and the lazy GRU: round-off times the layers'
    # gain (port 4e-7 at most); the control parts by 7e-3 or more
    emb=2e-5,
    # the BCE means of 100 logits (port 1.6e-7 at most); the control
    # parts by 6e-4 or more
    loss=2e-6,
    # the worst leaf's norm (``checks.leaf_gap``; port 1.2e-7 at most); the
    # control parts by 5e-3 or more
    grad=1e-4,
    # Σ|Δ|/Σ|ref| over the memory table after two protocols; the control's
    # bf16 table parts by 2e-3 or more (the port's table is bit-equal here)
    memory=1e-5,
    # the worst leaf's change over three Adam steps, quiet leaves left out:
    # Adam's first steps divide by √v, so a leaf's change carries its
    # gradient's relative round-off (seen up to 2.5e-4); the control parts
    # by 0.17 or more
    change=1e-3,
)


def _run(n_layer: int, tmp_path):
    ev = streams.synthetic_events(600, 40, 24, SEED)
    sp = streams.split(ev)
    feats = edge_features(len(ev) + 1, EDGE, SEED, "cpu")
    cfg = Config(embedding_module="graph_attention", n_layer=n_layer,
                 n_degree=N, n_head=2, node_dim=DIM, memory_dim=DIM,
                 time_dim=DIM, bs=BS, memory_dtype="float32",
                 message_dtype="float32", seed=SEED,
                 checkpoint_dir=str(tmp_path), log_dir=str(tmp_path))
    trainer = Trainer(cfg, program.splits(sp), feats.numpy(), device="cpu")
    dims = tgn.dims(DIM, DIM, EDGE, N)
    params0 = weights_tgn.make_params(dims, n_layer, SEED, "cpu")
    trainer.set_params(program.param_tree(params0))

    import zebra_tpu_torch.models.embedding as emb_mod
    import zebra_tpu_torch.train.phase as phase

    got = dict(trees=[], embs=[])
    orig_tree, orig_fwd = emb_mod.hop_tree, phase._forward
    opt = trainer.optimizer
    orig_step = opt.step
    count = [0]

    def hop_tree(*a, **kw):
        tree = orig_tree(*a, **kw)
        if len(got["trees"]) < STEPS:
            got["trees"].append([tgn.Level(
                *(None if x is None else x.numpy().copy()
                  for x in (h.nodes, h.times, h.eidx, h.valid)))
                for h in tree])
        return tree

    def forward(*a, **kw):
        out = orig_fwd(*a, **kw)
        if len(got["embs"]) < STEPS:
            got["embs"].append(out.detach().clone())
        return out

    def step(*a, **kw):
        out = orig_step(*a, **kw)
        count[0] += 1
        if count[0] == 1:
            got["grads"] = {k: v / 0.1 for k, v in
                            program.first_moments(trainer).items()}
        if count[0] == STEPS:
            got["params"] = program.parameters(trainer)
            got["memory"] = trainer.mem.memory.detach().clone()
        return out

    emb_mod.hop_tree, phase._forward, opt.step = hop_tree, forward, step
    try:
        r = trainer.train_epoch(max_chunks=1)
    finally:
        emb_mod.hop_tree, phase._forward = orig_tree, orig_fwd
        del opt.step
    got["losses"] = list(r.per_batch[:STEPS, 0])
    n_real = sp.n_nodes + 1
    got["memory"] = got["memory"][:n_real]

    # the reference, fed the same stream, weights and negatives
    tr = sp.train
    adj = tgn.Adjacency(tr.src, tr.dst, tr.t, tr.eidx, n_real)
    negs = streams.train_negatives(tr, streams.neg_base(SEED), 0)
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt)
    batches = []
    for i in range(STEPS):
        sl = slice(i * BS, (i + 1) * BS)
        roots = np.concatenate([tr.src[sl], tr.dst[sl], negs[sl]])
        batches.append(dict(
            src=as_t(tr.src[sl], torch.long), dst=as_t(tr.dst[sl], torch.long),
            neg=as_t(negs[sl], torch.long),
            t=as_t(tr.t[sl].astype(np.float32), torch.float32),
            eidx=as_t(tr.eidx[sl], torch.long),
            tree=tgn.hop_tree(adj, roots, np.tile(tr.t[sl], 3), N, n_layer)))
    refs = {}
    for low in (False, True):
        embs = []
        steps, mem, final = tgn.train_steps(
            params0, tgn.Prec(low), dims, 2, cfg.lr, n_real, feats, batches,
            embs)
        refs[low] = dict(embs=embs, losses=[s.loss for s in steps],
                         grads=steps[0].grads, params=final,
                         memory=mem.memory)
    return got, refs, [b["tree"] for b in batches], params0


def _gaps(got, ref, params0):
    """Each compared number of ``got`` against ``ref``."""
    emb = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got["embs"], ref["embs"]))
    d_got = {k: got["params"][k] - params0[k] for k in params0}
    d_ref = {k: ref["params"][k] - params0[k] for k in params0}
    return dict(
        emb=emb, loss=checks.rel_gap(got["losses"], ref["losses"]),
        grad=checks.leaf_gap(got["grads"], ref["grads"]),
        memory=checks.table_gap(got["memory"], ref["memory"]),
        change=checks.leaf_gap(d_got, d_ref,
                               checks.quiet_leaves(ref["grads"])))


@pytest.fixture(scope="module", params=[1, 2], ids=["1hop", "2hop"])
def run(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory.mktemp("tgn"))


def test_hop_trees_equal_the_plain_search(run):
    got, _, ref_trees, _ = run
    assert len(got["trees"]) == STEPS
    for g, r in zip(got["trees"], ref_trees):
        assert len(g) == len(r)
        np.testing.assert_array_equal(g[0].nodes, r[0].nodes)
        for gl, rl in zip(g[1:], r[1:]):
            np.testing.assert_array_equal(gl.valid, rl.valid)
            np.testing.assert_array_equal(gl.nodes, rl.nodes)
            np.testing.assert_array_equal(gl.times, rl.times)
            np.testing.assert_array_equal(gl.eidx, rl.eidx)
        assert tgn.tree_gap(r, g) == 0.0
    # the trees have both kinds of slot
    valid = np.concatenate([lv.valid.reshape(-1) for t in ref_trees
                            for lv in t[1:]])
    assert valid.any() and not valid.all()


def test_port_within_every_tolerance(run):
    got, refs, _, params0 = run
    gaps = _gaps(got, refs[False], params0)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


def test_control_outside_every_tolerance(run):
    """The reference in bfloat16 fails each tolerance: each is tight
    enough to see the precision below the configuration's."""
    _, refs, _, params0 = run
    gaps = _gaps(refs[True], refs[False], params0)
    assert all(gaps[k] > TOL[k] for k in TOL), gaps
