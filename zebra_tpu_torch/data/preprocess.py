"""Offline preprocessors writing ``ml_{name}.csv`` (+ ``ml_{name}.npy``):
a numpy copy of ``zebra_tpu/data/preprocess.py`` whose files hold the same
values, byte for byte in the CSV (no pandas, no native ingest library).

Two input formats:
- JODIE CSV (a header line, then ``u,i,ts,label,feat...``): ids become
  1-based; for bipartite graphs item ids are first offset by the user
  count so both sides share one id space; edge features get a zero row 0.
- SNAP whitespace ``u i ts`` (AskUbuntu, SuperUser, Wiki-Talk): events are
  sorted by time (stably), times shifted to start at 0, node ids compacted
  in numeric order, label 0, no features.

CLI::

    python -m zebra_tpu_torch.data.preprocess --data wikipedia --bipartite
    python -m zebra_tpu_torch.data.preprocess --data superuser --format snap
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

Columns = Dict[str, np.ndarray]   # u, i (int64), ts, label (float64), idx


def reindex(cols: Columns, bipartite: bool = True) -> Columns:
    """Ids 1-based; for a bipartite graph item ids are offset by the user
    count first."""
    u, i = cols["u"], cols["i"]
    if bipartite:
        if (u.max() - u.min() + 1 != len(np.unique(u))
                or i.max() - i.min() + 1 != len(np.unique(i))):
            raise ValueError("bipartite ids must be contiguous on each side")
        i = i + u.max() + 1
    return dict(cols, u=u + 1, i=i + 1, idx=cols["idx"] + 1)


def preprocess_jodie(path: str) -> Tuple[Columns, np.ndarray]:
    """Parse a JODIE CSV: (columns, features [n, d], d ≥ 0)."""
    table = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2,
                       dtype=np.float64)
    n = table.shape[0]
    cols = {"u": table[:, 0].astype(np.int64),
            "i": table[:, 1].astype(np.int64),
            "ts": table[:, 2], "label": table[:, 3],
            "idx": np.arange(n, dtype=np.int64)}
    return cols, table[:, 4:]


def preprocess_snap(path: str) -> Columns:
    """Parse whitespace ``u i ts`` (further fields ignored): sort by time,
    shift times to 0, compact node ids to 0..n-1 in numeric order."""
    ids = np.loadtxt(path, usecols=(0, 1), ndmin=2, dtype=np.int64)
    ts = np.loadtxt(path, usecols=(2,), ndmin=1, dtype=np.float64)
    order = np.argsort(ts, kind="stable")
    u, i, ts = ids[order, 0], ids[order, 1], ts[order]
    uniq = np.unique(np.concatenate([u, i]))
    return {"u": np.searchsorted(uniq, u), "i": np.searchsorted(uniq, i),
            "ts": ts - ts.min() if len(ts) else ts,
            "label": np.zeros(len(u)), "idx": np.arange(len(u))}


def write_ml(out_dir, name: str, cols: Columns,
             edge_feats: Optional[np.ndarray] = None) -> str:
    """Write ``ml_{name}.csv`` as ``DataFrame.to_csv`` does (a leading
    unnamed index column; floats by ``repr``) and, given ``edge_feats``
    (zero row 0 included), ``ml_{name}.npy``. Returns the CSV's path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_csv = out_dir / f"ml_{name}.csv"
    rows = zip(np.asarray(cols["u"]).tolist(), np.asarray(cols["i"]).tolist(),
               np.asarray(cols["ts"], np.float64).tolist(),
               np.asarray(cols["label"], np.float64).tolist(),
               np.asarray(cols["idx"]).tolist())
    with open(out_csv, "w") as f:
        f.write(",u,i,ts,label,idx\n")
        f.writelines(f"{n},{u},{i},{ts!r},{label!r},{idx}\n"
                     for n, (u, i, ts, label, idx) in enumerate(rows))
    if edge_feats is not None:
        np.save(out_dir / f"ml_{name}.npy", edge_feats)
    return str(out_csv)


def run(data_name: str, data_dir: str = "data", bipartite: bool = False,
        fmt: str = "jodie") -> str:
    """Preprocess ``{data_dir}/{name}/{name}.csv`` (JODIE) or
    ``{data_dir}/{name}/{name}`` (SNAP) into ``ml_{name}.csv`` (+
    ``ml_{name}.npy``, JODIE with features only)."""
    out_dir = Path(data_dir) / data_name
    if fmt == "jodie":
        cols, feat = preprocess_jodie(str(out_dir / f"{data_name}.csv"))
        edge_feats = None
        if feat.shape[1] > 0:
            edge_feats = np.vstack([np.zeros((1, feat.shape[1])), feat])
        return write_ml(out_dir, data_name, reindex(cols, bipartite),
                        edge_feats)
    if fmt == "snap":
        cols = preprocess_snap(str(out_dir / data_name))
        return write_ml(out_dir, data_name, reindex(cols, bipartite))
    raise ValueError(f"unknown format {fmt!r}")


def main(argv=None):
    p = argparse.ArgumentParser("zebra_tpu_torch offline preprocessing")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--bipartite", action="store_true")
    p.add_argument("--format", dest="fmt", choices=["jodie", "snap"],
                   default="jodie")
    args = p.parse_args(argv)
    print(run(args.data, args.data_dir, args.bipartite, args.fmt))


if __name__ == "__main__":
    main()
