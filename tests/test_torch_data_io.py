"""The port's dataset files (zebra_tpu_torch/data/preprocess.py, get_data,
load_feat) against the JAX package's, with no pandas in the port:

- the preprocessor writes the JAX preprocessor's files byte for byte (JODIE
  with and without the bipartite offset, SNAP);
- get_data/load_feat on a file the JAX preprocessor wrote give its splits.
  One documented difference: the port reads a timestamp's decimal exactly
  (as pandas does with float_precision="round_trip"); pandas' default
  parser, which the JAX package uses, can land one ulp off it. So times
  are held equal to the exact parse and within one ulp of the JAX split;
  every other column, and every split's membership, is identical."""

import filecmp

import numpy as np
import pandas as pd
import pytest

from zebra_tpu.data import preprocess as jax_preprocess
from zebra_tpu.data.dataset import compute_time_statistics as jax_time_stats
from zebra_tpu.data.dataset import get_data as jax_get_data
from zebra_tpu.data.dataset import load_feat as jax_load_feat
from zebra_tpu_torch.data import preprocess
from zebra_tpu_torch.data.dataset import (
    compute_time_statistics,
    get_data,
    load_feat,
    read_ml_csv,
)

PARTS = ("full", "train", "val", "test", "new_node_val", "new_node_test")


def _jodie(root, name="toy", n=400, seed=0):
    """A JODIE CSV: contiguous user and item ids from 0, float times with
    full-precision decimals, 0/1 labels and two features."""
    rng = np.random.RandomState(seed)
    d = root / name
    d.mkdir(parents=True)
    with open(d / f"{name}.csv", "w") as f:
        f.write("user_id,item_id,timestamp,state_label,f0,f1\n")
        users = np.concatenate([np.arange(30), rng.randint(0, 30, n - 30)])
        items = np.concatenate([np.arange(25), rng.randint(0, 25, n - 25)])
        for k in range(n):
            f.write(f"{users[k]},{items[k]},{k * 1.37 + rng.rand()!r},"
                    f"{rng.randint(0, 2)},{rng.rand()!r},{rng.randn()!r}\n")


def _snap(root, name="chat", n=300, seed=0):
    rng = np.random.RandomState(seed)
    d = root / name
    d.mkdir(parents=True)
    with open(d / name, "w") as f:
        for _ in range(n):
            f.write(f"{rng.randint(0, 5000)} {rng.randint(0, 5000)} "
                    f"{rng.randint(0, 100)}\n")


@pytest.mark.parametrize("fmt,bipartite", [("jodie", True), ("jodie", False),
                                           ("snap", False)])
def test_preprocess_writes_the_jax_files(tmp_path, fmt, bipartite):
    outs = []
    for side in ("jax", "port"):
        root = tmp_path / side
        (_jodie if fmt == "jodie" else _snap)(root)
        name = "toy" if fmt == "jodie" else "chat"
        run = (jax_preprocess if side == "jax" else preprocess).run
        outs.append((root / name, run(name, str(root), bipartite, fmt)))
    (jdir, jcsv), (pdir, pcsv) = outs
    assert filecmp.cmp(jcsv, pcsv, shallow=False)
    if fmt == "jodie":
        jf, pf = np.load(jdir / "ml_toy.npy"), np.load(pdir / "ml_toy.npy")
        assert jf.dtype == pf.dtype and np.array_equal(jf, pf)
        assert not pf[0].any()
    else:
        assert not (pdir / "ml_chat.npy").exists()


def test_preprocess_cli(tmp_path, capsys):
    _jodie(tmp_path)
    preprocess.main(["--data", "toy", "--data_dir", str(tmp_path),
                     "--bipartite"])
    out = capsys.readouterr().out.strip()
    assert out.endswith("ml_toy.csv") and read_ml_csv(out)["u"].min() == 1


def test_bipartite_needs_contiguous_ids(tmp_path):
    cols = {"u": np.array([0, 2]), "i": np.array([0, 1]),
            "ts": np.zeros(2), "label": np.zeros(2), "idx": np.arange(2)}
    with pytest.raises(ValueError, match="contiguous"):
        preprocess.reindex(cols, bipartite=True)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _jodie(root, n=1200)
    path = jax_preprocess.run("toy", str(root), bipartite=True, fmt="jodie")
    return root, path


@pytest.mark.parametrize("part", PARTS)
def test_get_data_gives_the_jax_splits(jax_written, part):
    root, path = jax_written
    got = getattr(get_data("toy", str(root)), part)
    want = getattr(jax_get_data("toy", str(root)), part)
    for f in ("sources", "destinations", "edge_idxs", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    exact = pd.read_csv(path, float_precision="round_trip").ts.to_numpy()
    assert got.timestamps.dtype == np.float64
    assert np.isin(got.timestamps, exact).all()
    np.testing.assert_array_max_ulp(got.timestamps, want.timestamps, maxulp=1)


def test_get_data_sizes_and_features_match_jax(jax_written):
    root, _ = jax_written
    got, want = get_data("toy", str(root)), jax_get_data("toy", str(root))
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    for g, w in zip(load_feat("toy", str(root)), jax_load_feat("toy",
                                                               str(root))):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)


def test_get_data_reads_a_file_without_the_index_column(jax_written,
                                                        tmp_path):
    root, path = jax_written
    d = tmp_path / "plain"
    d.mkdir()
    pd.read_csv(path, index_col=0, float_precision="round_trip").to_csv(
        d / "ml_plain.csv", index=False)
    a, b = get_data("plain", str(tmp_path)), get_data("toy", str(root))
    for part in PARTS:
        for f in ("sources", "destinations", "timestamps", "edge_idxs",
                  "labels"):
            np.testing.assert_array_equal(getattr(getattr(a, part), f),
                                          getattr(getattr(b, part), f))


def test_read_ml_csv_refuses_a_missing_column(tmp_path):
    path = tmp_path / "ml_bad.csv"
    path.write_text("u,i,ts,idx\n1,2,0.5,1\n")
    with pytest.raises(ValueError, match="label"):
        read_ml_csv(str(path))


def test_compute_time_statistics_matches_jax(jax_written):
    root, _ = jax_written
    full = get_data("toy", str(root)).full
    args = (full.sources, full.destinations, full.timestamps)
    np.testing.assert_allclose(compute_time_statistics(*args),
                               jax_time_stats(*args), rtol=1e-12)
