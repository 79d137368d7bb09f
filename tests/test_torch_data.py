"""The port's data layer against the JAX package's, exactly: every raw
format parser on files written as tests/test_parsers.py writes them (the
writers copied), the registry's synthetic stand-ins (compared within one
process: their seed is Python's string hash, as in the JAX registry), the
Errica fold fixtures, the transforms, the native degree features,
`reorder_graph`, and `NeighborSampler` batches field by field against the
JAX GraphBatch of the same seed."""
import gzip
import pickle
import warnings

import numpy as np
import pytest
import torch

from kagnn_tpu import data as jdata
from kagnn_tpu.data import native as jnative
from kagnn_tpu.data import planetoid as jplanetoid
from kagnn_tpu.data import sampling as jsampling
from kagnn_tpu.data import transforms as jtransforms
from kagnn_tpu.data import tu as jtu
from kagnn_tpu.data import zinc as jzinc
from kagnn_tpu.graphs import reorder as jreorder
from kagnn_tpu_torch import data as tdata
from kagnn_tpu_torch.data import native as tnative
from kagnn_tpu_torch.data import planetoid as tplanetoid
from kagnn_tpu_torch.data import sampling as tsampling
from kagnn_tpu_torch.data import transforms as ttransforms
from kagnn_tpu_torch.data import tu as ttu
from kagnn_tpu_torch.data import zinc as tzinc
from kagnn_tpu_torch.data.synthetic import community_node_graph
from kagnn_tpu_torch.graphs import reorder as treorder

torch.set_num_threads(1)


def assert_same(a, b, path="out"):
    """Equal structure, types and values, arrays exactly (dtype included)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


# ---------------------------------------------------------------- writers
# the raw layouts of tests/test_parsers.py

def write_tu(root, rng):
    raw = root / "FAKE" / "raw"
    raw.mkdir(parents=True)
    edges = [(1, 2), (2, 1), (2, 3), (3, 2), (1, 3), (3, 1), (4, 5), (5, 4)]
    (raw / "FAKE_A.txt").write_text(
        "\n".join(f"{a}, {b}" for a, b in edges) + "\n")
    (raw / "FAKE_graph_indicator.txt").write_text("1\n1\n1\n2\n2\n")
    (raw / "FAKE_graph_labels.txt").write_text("1\n-1\n")
    (raw / "FAKE_node_labels.txt").write_text("0\n1\n0\n2\n1\n")
    (raw / "FAKE_node_attributes.txt").write_text(
        "\n".join(", ".join(f"{v:.4f}" for v in rng.normal(size=3))
                  for _ in range(5)) + "\n")
    return lambda m: m.load_tu_dataset("FAKE", str(root), use_node_attr=True)


def write_tu_unlabelled(root, rng):
    raw = root / "NOLAB" / "raw"
    raw.mkdir(parents=True)
    (raw / "NOLAB_A.txt").write_text("1, 2\n2, 1\n2, 3\n3, 2\n4, 4\n")
    (raw / "NOLAB_graph_indicator.txt").write_text("1\n1\n1\n2\n")
    (raw / "NOLAB_graph_labels.txt").write_text("0\n3\n")
    return lambda m: m.load_tu_dataset("NOLAB", str(root))


def write_zinc(root, rng):
    raw = root / "ZINC" / "raw"
    raw.mkdir(parents=True)
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        mols = []
        for i in range(n):
            nn_ = 3 + i
            adj = np.zeros((nn_, nn_), np.int64)
            for a in range(nn_ - 1):
                adj[a, a + 1] = adj[a + 1, a] = 1 + (a % 3)
            # the real pickles hold torch tensors
            mols.append({"atom_type": torch.arange(nn_) % 5,
                         "bond_type": torch.from_numpy(adj),
                         "logP_SA_cycle_normalized": torch.tensor(float(i) / 2)})
        with open(raw / f"{split}.pickle", "wb") as f:
            pickle.dump(mols, f)
        (raw / f"{split}.index").write_text(
            ",".join(str(j) for j in range(min(2, n))))
    return lambda m: m.load_zinc(str(root))


def write_geom_gcn(root, rng):
    raw = root / "Texas" / "raw"
    raw.mkdir(parents=True)
    n = 6
    lines = ["id\tfeat\tlabel"]
    for i in range(n):
        feats = ",".join(str(v) for v in rng.integers(0, 2, 4))
        lines.append(f"{i}\t{feats}\t{i % 3}")
    (raw / "out1_node_feature_label.txt").write_text("\n".join(lines) + "\n")
    (raw / "out1_graph_edges.txt").write_text(
        "src\tdst\n0\t1\n1\t2\n2\t3\n3\t4\n4\t5\n")
    for i in range(10):
        m = np.zeros(n, bool)
        m[i % n] = True
        np.savez(raw / f"texas_split_0.6_0.2_{i}.npz",
                 train_mask=m, val_mask=~m & (np.arange(n) < 3),
                 test_mask=~m & (np.arange(n) >= 3))
    return lambda m: m.load_geom_gcn("Texas", str(root))


def _planetoid(root, rng, name, n_allx, test_ids, F, C, graph):
    import scipy.sparse as sp

    raw = root / name / "raw"
    raw.mkdir(parents=True)
    allx = (rng.random((n_allx, F)) < 0.3).astype(np.float32)
    allx[:, 0] = 1.0
    tx = (rng.random((len(test_ids), F)) < 0.3).astype(np.float32)
    tx[:, 0] = 1.0
    ally = np.eye(C)[rng.integers(0, C, n_allx)]
    ty = np.eye(C)[rng.integers(0, C, len(test_ids))]

    def dump(suf, obj):
        with open(raw / f"ind.{name.lower()}.{suf}", "wb") as f:
            pickle.dump(obj, f, protocol=2)

    dump("x", sp.csr_matrix(allx[:40]))
    dump("y", ally[:40])
    dump("allx", sp.csr_matrix(allx))
    dump("ally", ally)
    dump("tx", sp.csr_matrix(tx))
    dump("ty", ty)
    dump("graph", graph)
    (raw / f"ind.{name.lower()}.test.index").write_text(
        "\n".join(str(i) for i in rng.permutation(test_ids)) + "\n")
    return lambda m: m.load_planetoid(name, str(root))


def write_planetoid(root, rng):
    return _planetoid(root, rng, "Fake", 560, np.arange(560, 600), 8, 2,
                      {0: [1, 1, 2, 0], 1: [0], 2: [0], 5: [599]})


def write_citeseer(root, rng):
    return _planetoid(root, rng, "CiteSeer", 530,
                      np.asarray([530, 531, 533, 535, 536, 538, 539]), 4, 2,
                      {0: [1], 1: [0]})


def write_ogbn_arxiv(root, rng):
    base = root / "ogbn-arxiv" / "arxiv"
    (base / "raw").mkdir(parents=True)
    (base / "split" / "time").mkdir(parents=True)
    n, F = 12, 5

    def wcsv(path, arr, fmt):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    wcsv(base / "raw" / "edge.csv.gz",
         np.asarray([[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [1, 0]]), "%d")
    wcsv(base / "raw" / "node-feat.csv.gz",
         rng.normal(size=(n, F)).astype(np.float32), "%.6f")
    wcsv(base / "raw" / "node-label.csv.gz", rng.integers(0, 3, n), "%d")
    for split, ids in (("train", np.arange(0, 6)), ("valid", np.arange(6, 9)),
                       ("test", np.arange(9, 12))):
        wcsv(base / "split" / "time" / f"{split}.csv.gz", ids, "%d")
    return lambda m: m.load_ogbn_arxiv(str(root))


QM9_SDF = """gdb_1
     RDKit          3D

  5  4  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    0.6300    0.6300    0.6300 H   0  0  0  0  0  0  0  0  0  0  0  0
   -0.6300   -0.6300    0.6300 H   0  0  0  0  0  0  0  0  0  0  0  0
   -0.6300    0.6300   -0.6300 H   0  0  0  0  0  0  0  0  0  0  0  0
    0.6300   -0.6300   -0.6300 H   0  0  0  0  0  0  0  0  0  0  0  0
  1  2  1  0
  1  3  1  0
  1  4  1  0
  1  5  1  0
M  END
$$$$
gdb_2
     RDKit          3D

  3  2  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.1173 O   0  0  0  0  0  0  0  0  0  0  0  0
    0.0000    0.7572   -0.4692 H   0  0  0  0  0  0  0  0  0  0  0  0
    0.0000   -0.7572   -0.4692 H   0  0  0  0  0  0  0  0  0  0  0  0
  1  2  1  0
  1  3  2  0
M  END
$$$$
"""


def write_qm9(root, rng):
    raw = root / "QM9" / "raw"
    raw.mkdir(parents=True)
    (raw / "gdb9.sdf").write_text(QM9_SDF)
    hdr = ",".join(["mol_id"] + [f"t{i}" for i in range(19)])
    rows = ["gdb_1," + ",".join(str(float(i)) for i in range(19)),
            "gdb_2," + ",".join(str(float(i + 100)) for i in range(19))]
    (raw / "gdb9.sdf.csv").write_text(hdr + "\n" + "\n".join(rows) + "\n")
    return lambda m: m.load_qm9(str(root))


PARSERS = {
    "tu": (write_tu, jtu, ttu),
    "tu_degree_features": (write_tu_unlabelled, jtu, ttu),
    "zinc": (write_zinc, jzinc, tzinc),
    "qm9": (write_qm9, jzinc, tzinc),
    "geom_gcn": (write_geom_gcn, jplanetoid, tplanetoid),
    "planetoid": (write_planetoid, jplanetoid, tplanetoid),
    "citeseer": (write_citeseer, jplanetoid, tplanetoid),
    "ogbn_arxiv": (write_ogbn_arxiv, jplanetoid, tplanetoid),
}


@pytest.mark.parametrize("fmt", sorted(PARSERS))
def test_parser_matches_jax(fmt, tmp_path, rng):
    write, jmod, tmod = PARSERS[fmt]
    load = write(tmp_path, rng)
    assert_same(load(jmod), load(tmod))


@pytest.mark.parametrize("kind", ["node", "graph", "regression"])
def test_registry_stand_ins_match_jax(kind, tmp_path):
    """Without raw files both registries fall back to the same synthetic
    stand-ins (in one process Python's string hash, their seed, agrees)."""
    name, fn = {"node": ("Cora", "load_node_dataset"),
                "graph": ("MUTAG", "load_graph_dataset"),
                "regression": ("ZINC", "load_regression_dataset")}[kind]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jdata, fn)(name, str(tmp_path))
        got = getattr(tdata, fn)(name, str(tmp_path))
    assert_same(want, got)
    with pytest.raises(FileNotFoundError):
        getattr(tdata, fn)(name, str(tmp_path), allow_synthetic=False)
    assert tdata.DATASET_LAYERS == jdata.DATASET_LAYERS
    assert (tdata.NODE_DATASETS, tdata.GRAPH_DATASETS) == (
        jdata.NODE_DATASETS, jdata.GRAPH_DATASETS)


@pytest.mark.parametrize("name", ["MUTAG", "PROTEINS_full", "IMDB-BINARY"])
def test_fold_fixtures_read_in_place(name):
    splits = tdata.load_splits(name)
    assert_same(jdata.load_splits(name), splits)
    assert len(splits) == 10
    for fold in (0, 9):
        assert_same(jdata.fold_indices(splits, fold),
                    tdata.fold_indices(splits, fold))


def test_transforms_match_jax(rng):
    x = rng.random((40, 7)).astype(np.float32)
    x[3] = 0.0
    assert_same(jtransforms.normalize_features(x.copy()),
                ttransforms.normalize_features(x.copy()))
    snd, rcv = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    assert_same(jtransforms.degree_one_hot(snd, 50),
                ttransforms.degree_one_hot(snd, 50))
    for dedup in (True, False):
        assert_same(jtransforms.to_undirected(snd, rcv, dedup),
                    ttransforms.to_undirected(snd, rcv, dedup))


def test_native_degree_features_match_jax():
    from kagnn_tpu_torch.data.synthetic import random_molecule_graphs

    graphs = random_molecule_graphs(12, 5, 30, seed=2)
    for g in graphs[:3]:  # hubs past the clip at 35
        g["senders"] = np.concatenate([g["senders"], np.zeros(40, np.int32)])
    theirs = [dict(g) for g in graphs]
    mine = [dict(g) for g in graphs]
    if not jnative.native_available():
        pytest.skip("the JAX package's native batcher does not build here")
    jnative.degree_onehot_features(theirs)
    tnative.degree_onehot_features(mine)
    for a, b, g in zip(theirs, mine, graphs):
        assert_same(a["nodes"], b["nodes"])
        assert_same(ttransforms.degree_one_hot(g["senders"], g["n_node"]),
                    b["nodes"])


@pytest.mark.parametrize("order", ["bfs_order", "degree_order"])
def test_reorder_graph_matches_jax(order):
    d = community_node_graph(n_nodes=300, n_classes=4, num_features=6, seed=5)
    d["train_masks"] = np.stack([d["masks"]["train"]] * 3)
    want = jreorder.reorder_graph(d, getattr(jreorder, order))
    got = treorder.reorder_graph(d, getattr(treorder, order))
    assert_same(want, got)
    perm = got["reorder_perm"]
    assert sorted(perm.tolist()) == list(range(300))


def _jax_batch_fields(b) -> dict:
    return {k: np.asarray(v) for k, v in vars(b).items() if v is not None}


def test_sampler_batches_match_jax():
    """Three batches of one epoch (fanouts 4 and 3 over a graph with a hub
    and isolated nodes), every JAX GraphBatch field equal to the port's,
    the port's CSR row pointers those of its receivers and sorted senders,
    the pads the JAX rules', and the seed mask."""
    d = community_node_graph(n_nodes=400, n_classes=4, num_features=5, seed=9)
    snd = np.concatenate([d["senders"], np.arange(1, 120)])
    rcv = np.concatenate([d["receivers"], np.zeros(119, np.int64)])
    keep = (snd < 390) & (rcv < 390)  # nodes 390-399 have no in-edges
    snd, rcv = snd[keep], rcv[keep]
    kw = dict(fanouts=[4, 3], batch_size=32, seed=7)
    js = jsampling.NeighborSampler(snd, rcv, 400, **kw)
    ts = tsampling.NeighborSampler(snd, rcv, 400, device="cpu", **kw)
    assert (ts.n_node_pad, ts.n_edge_pad) == (js.n_node_pad, js.n_edge_pad)
    assert ts.n_node_pad == -(-(32 + 128 + 384 + 1) // 8) * 8
    train = np.flatnonzero(d["masks"]["train"])
    train = np.concatenate([train, np.arange(390, 400)])
    n = 0
    for jb, tb in zip(js.epoch(train, d["nodes"], d["y"]),
                      ts.epoch(train, d["nodes"], d["y"])):
        for k, v in _jax_batch_fields(jb).items():
            got = getattr(tb, k)
            got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
            assert got.dtype == v.dtype or (v.ndim == 0 and got.ndim == 0), k
            np.testing.assert_array_equal(got, v, err_msg=k)
        rp = np.concatenate([[0], np.cumsum(np.bincount(
            tb.receivers.numpy(), minlength=tb.n_node_pad))])
        np.testing.assert_array_equal(tb.recv_row_ptr.numpy(), rp)
        sp = np.concatenate([[0], np.cumsum(np.bincount(
            tb.senders_sorted.numpy(), minlength=tb.n_node_pad))])
        np.testing.assert_array_equal(tb.send_row_ptr.numpy(), sp)
        assert tb.n_edge_pad - tb.n_edge > 0
        assert (tb.senders[tb.n_edge:] == tb.n_node_pad - 1).all()
        n += 1
        if n == 3:
            break
    assert n == 3
    np.testing.assert_array_equal(ts.seed_mask().numpy(),
                                  np.asarray(js.seed_mask()))
    assert ts.seed_mask().dtype == torch.bool
