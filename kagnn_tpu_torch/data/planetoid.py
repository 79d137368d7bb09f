"""Node-classification dataset loaders (raw on-disk formats; no network),
the counterparts of `kagnn_tpu/data/planetoid.py` (numpy and scipy,
verbatim).

Covers the reference's node-task registry
(node_classification_clean/utils.py:30-66):

  * Planetoid Cora/CiteSeer — parses the ind.<name>.* pickle/index raw files
    (the files `torch_geometric.datasets.Planetoid` downloads), with
    row-normalized features and the standard public split repeated x10;
  * WebKB Texas/Cornell/Wisconsin and Actor — parses out1_graph_edges.txt +
    out1_node_feature_label.txt plus the 10 geom-gcn split .npz files;
  * ogbn-arxiv — parses the OGB zip layout when present on disk.

Every loader returns a dict: senders, receivers, nodes (float32), y (int32),
train_masks/val_masks/test_masks of shape (10, n_node).
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np

from kagnn_tpu_torch.data.transforms import normalize_features, to_undirected


def _pickle_load(path: str):
    with open(path, "rb") as f:
        if sys.version_info > (3, 0):
            return pickle.load(f, encoding="latin1")
        return pickle.load(f)


def load_planetoid(name: str, root: str = "data") -> dict:
    """name in {Cora, CiteSeer, PubMed} (lowercased file prefix)."""
    prefix = None
    for cand in (os.path.join(root, name, name, "raw"),
                 os.path.join(root, name, "raw"), os.path.join(root, name)):
        if os.path.exists(os.path.join(cand, f"ind.{name.lower()}.x")):
            prefix = cand
            break
    if prefix is None:
        raise FileNotFoundError(f"Planetoid raw files for {name} not under {root}")

    objs = {}
    for suf in ("x", "y", "tx", "ty", "allx", "ally", "graph"):
        objs[suf] = _pickle_load(os.path.join(prefix, f"ind.{name.lower()}.{suf}"))
    test_idx = np.loadtxt(os.path.join(prefix, f"ind.{name.lower()}.test.index"),
                          dtype=np.int64)
    test_sorted = np.sort(test_idx)

    allx = objs["allx"].toarray() if hasattr(objs["allx"], "toarray") else objs["allx"]
    tx = objs["tx"].toarray() if hasattr(objs["tx"], "toarray") else objs["tx"]
    ally, ty = np.asarray(objs["ally"]), np.asarray(objs["ty"])

    if name.lower() == "citeseer":
        # citeseer has isolated test nodes missing from tx: re-index densely
        span = int(test_sorted.max()) - int(test_sorted.min()) + 1
        tx_full = np.zeros((span, tx.shape[1]), tx.dtype)
        ty_full = np.zeros((span, ty.shape[1]), ty.dtype)
        tx_full[test_sorted - test_sorted.min()] = tx
        ty_full[test_sorted - test_sorted.min()] = ty
        tx, ty = tx_full, ty_full

    x = np.vstack([allx, tx]).astype(np.float32)
    y_oh = np.vstack([ally, ty])
    x[test_idx] = x[test_sorted]
    y_oh[test_idx] = y_oh[test_sorted]
    y = y_oh.argmax(1).astype(np.int32)
    n = x.shape[0]

    snd, rcv = [], []
    for src, dsts in objs["graph"].items():
        for d in dsts:
            snd.append(src)
            rcv.append(d)
    senders, receivers = to_undirected(np.asarray(snd), np.asarray(rcv))
    # drop self loops (PyG Planetoid uses coalesced edge list incl. none)
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]

    x = normalize_features(x)  # reference applies NormalizeFeatures

    n_cls = y_oh.shape[1]
    train_mask = np.zeros(n, bool)
    train_mask[: n_cls * 20] = True  # standard split: 20 per class, first rows
    val_mask = np.zeros(n, bool)
    val_mask[n_cls * 20: n_cls * 20 + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx] = True
    return dict(
        senders=senders, receivers=receivers, nodes=x, y=y, n_node=n,
        train_masks=np.repeat(train_mask[None], 10, 0),
        val_masks=np.repeat(val_mask[None], 10, 0),
        test_masks=np.repeat(test_mask[None], 10, 0),
        num_classes=n_cls,
    )


def load_geom_gcn(name: str, root: str = "data") -> dict:
    """WebKB (Texas/Cornell/Wisconsin) and Actor (film) raw format with the
    10 geom-gcn split files the reference uses
    (node_classification_clean/utils.py:49-59)."""
    sub = "film" if name == "Actor" else name.lower()
    base = None
    for cand in (os.path.join(root, name, name, "raw"),
                 os.path.join(root, name, "raw"), os.path.join(root, name)):
        if os.path.exists(os.path.join(cand, "out1_graph_edges.txt")):
            base = cand
            break
    if base is None:
        raise FileNotFoundError(f"geom-gcn raw files for {name} not under {root}")

    with open(os.path.join(base, "out1_node_feature_label.txt")) as f:
        lines = f.read().strip().split("\n")[1:]
    ids, feats, labels = [], [], []
    for line in lines:
        nid, feat, label = line.split("\t")
        ids.append(int(nid))
        labels.append(int(label))
        feats.append(np.asarray(feat.split(","), dtype=np.int64))
    n = max(ids) + 1
    if name == "Actor":
        # features are keyword indices -> multi-hot of size 932
        x = np.zeros((n, 932), np.float32)
        for nid, fs in zip(ids, feats):
            x[nid, fs] = 1.0
    else:
        x = np.zeros((n, len(feats[0])), np.float32)
        for nid, fs in zip(ids, feats):
            x[nid] = fs
    y = np.zeros(n, np.int32)
    y[ids] = labels

    edges = np.loadtxt(os.path.join(base, "out1_graph_edges.txt"),
                       skiprows=1, dtype=np.int64)
    senders, receivers = to_undirected(edges[:, 0], edges[:, 1])
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]

    x = normalize_features(x)
    tr, va, te = [], [], []
    for i in range(10):
        f = np.load(os.path.join(
            base, f"{sub}_split_0.6_0.2_{i}.npz"))
        tr.append(f["train_mask"].astype(bool))
        va.append(f["val_mask"].astype(bool))
        te.append(f["test_mask"].astype(bool))
    return dict(senders=senders, receivers=receivers, nodes=x, y=y, n_node=n,
                train_masks=np.stack(tr), val_masks=np.stack(va),
                test_masks=np.stack(te), num_classes=int(y.max()) + 1)


def load_ogbn_arxiv(root: str = "data") -> dict:
    """ogbn-arxiv from the extracted OGB directory layout
    (reference utils.py:31-43; standard split repeated x10).

    Deliberate deviation: the citation edges are symmetrized here (standard
    OGB-leaderboard practice), while the reference trains on the raw
    directed edge_index."""
    import gzip

    base = None
    for cand in (os.path.join(root, "ogbn-arxiv", "arxiv"),
                 os.path.join(root, "ogbn-arxiv"),
                 os.path.join(root, "arxiv")):
        if os.path.exists(os.path.join(cand, "raw", "edge.csv.gz")):
            base = cand
            break
    if base is None:
        raise FileNotFoundError(f"ogbn-arxiv raw files not under {root}")

    def rcsv(p, dtype):
        with gzip.open(os.path.join(base, "raw", p), "rt") as f:
            return np.loadtxt(f, delimiter=",", dtype=dtype)

    edge = rcsv("edge.csv.gz", np.int64)
    x = rcsv("node-feat.csv.gz", np.float32)
    y = rcsv("node-label.csv.gz", np.int64).astype(np.int32).reshape(-1)
    n = x.shape[0]
    senders, receivers = to_undirected(edge[:, 0], edge[:, 1])

    def ridx(split):
        with gzip.open(os.path.join(base, "split", "time", f"{split}.csv.gz"),
                       "rt") as f:
            return np.loadtxt(f, dtype=np.int64)

    masks = {}
    for split in ("train", "valid", "test"):
        m = np.zeros(n, bool)
        m[ridx(split)] = True
        masks[split] = m
    return dict(senders=senders, receivers=receivers, nodes=x, y=y, n_node=n,
                train_masks=np.repeat(masks["train"][None], 10, 0),
                val_masks=np.repeat(masks["valid"][None], 10, 0),
                test_masks=np.repeat(masks["test"][None], 10, 0),
                num_classes=int(y.max()) + 1)
