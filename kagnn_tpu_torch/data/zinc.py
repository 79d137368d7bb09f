"""ZINC-subset and QM9 loaders (graph regression), the counterparts of
`kagnn_tpu/data/zinc.py` (numpy, verbatim).

ZINC: parses the pickled index/graph files of the benchmarking-gnns release
(`molecules/{train,val,test}.pickle` + `{train,val,test}.index` for the 12k
subset) that `torch_geometric.datasets.ZINC` downloads — the same data the
reference loads at graph_regression/optuna_zinc.py:140-142.

QM9: parses the `gdb9.sdf` + `gdb9.sdf.csv` raw files (targets only need the
csv; atom/bond features derived from the SDF blocks) as used via
`torch_geometric.datasets.QM9` at optuna_qm9.py:144-150. The reference uses
the first 12 targets z-score normalized.

The real ZINC pickles hold torch tensors; `np.asarray` reads them as the
JAX loader does.
"""
from __future__ import annotations

import os
import pickle

import numpy as np


def _find(root: str, *names: str):
    for name in names:
        for cand in (os.path.join(root, "ZINC", "raw", name),
                     os.path.join(root, "ZINC", name),
                     os.path.join(root, name)):
            if os.path.exists(cand):
                return cand
    return None


def load_zinc(root: str = "datasets", subset: bool = True):
    """Returns (train, val, test) graph-dict lists. Node feature: atom type
    int (N,1); edge feature: bond type int (E,1); y: float."""
    splits = {}
    for split in ("train", "val", "test"):
        pkl = _find(root, f"{split}.pickle")
        if pkl is None:
            raise FileNotFoundError(f"ZINC {split}.pickle not under {root}")
        with open(pkl, "rb") as f:
            mols = pickle.load(f)
        idx_file = _find(root, f"{split}.index")
        if subset and idx_file is not None:
            with open(idx_file) as f:
                idx = [int(i) for i in f.read().split(",") if i.strip()]
            mols = [mols[i] for i in idx]
        graphs = []
        for mol in mols:
            atom = np.asarray(mol["atom_type"], np.int32).reshape(-1, 1)
            n = atom.shape[0]
            adj = np.asarray(mol["bond_type"])
            snd, rcv = np.nonzero(adj)
            bond = adj[snd, rcv].astype(np.int32).reshape(-1, 1)
            y = np.array([float(mol["logP_SA_cycle_normalized"])], np.float32)
            graphs.append(dict(senders=snd.astype(np.int32),
                               receivers=rcv.astype(np.int32), n_node=int(n),
                               nodes=atom, edges=bond, y=y))
        splits[split] = graphs
    return splits["train"], splits["val"], splits["test"]


# QM9 SDF parsing -------------------------------------------------------------

_ATOM_TYPES = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}


def load_qm9(root: str = "datasets", max_molecules: int | None = None):
    """Parse gdb9.sdf / gdb9.sdf.csv. Returns a single list of graph dicts
    (the reference splits randomly 80/10/10 per seed, optuna_qm9.py:159-160);
    y is the (19,) target vector — consumers slice the first 12 and z-score
    normalize per the reference protocol."""
    sdf = None
    for cand in (os.path.join(root, "QM9", "raw", "gdb9.sdf"),
                 os.path.join(root, "qm9", "raw", "gdb9.sdf"),
                 os.path.join(root, "gdb9.sdf")):
        if os.path.exists(cand):
            sdf = cand
            break
    if sdf is None:
        raise FileNotFoundError(f"QM9 gdb9.sdf not under {root}")
    csv = sdf + ".csv"
    targets = {}
    with open(csv) as f:
        header = f.readline().strip().split(",")
        for line in f:
            parts = line.strip().split(",")
            targets[parts[0]] = np.asarray(parts[1:], np.float32)

    graphs = []
    with open(sdf) as f:
        content = f.read()
    for block in content.split("$$$$\n"):
        if not block.strip():
            continue
        lines = block.split("\n")
        name = lines[0].strip()
        counts = lines[3]
        try:
            n_atoms = int(counts[0:3])
            n_bonds = int(counts[3:6])
        except ValueError:
            continue
        atom_z = []
        ok = True
        for i in range(n_atoms):
            sym = lines[4 + i].split()[3]
            if sym not in _ATOM_TYPES:
                ok = False
                break
            atom_z.append(_ATOM_TYPES[sym])
        if not ok or name not in targets:
            continue
        snd, rcv, bond = [], [], []
        for i in range(n_bonds):
            bl = lines[4 + n_atoms + i]
            a = int(bl[0:3]) - 1
            b = int(bl[3:6]) - 1
            t = int(bl[6:9])
            snd += [a, b]
            rcv += [b, a]
            bond += [t - 1, t - 1]
        graphs.append(dict(
            senders=np.asarray(snd, np.int32),
            receivers=np.asarray(rcv, np.int32), n_node=n_atoms,
            nodes=np.asarray(atom_z, np.int32).reshape(-1, 1),
            edges=np.asarray(bond, np.int32).reshape(-1, 1),
            y=targets[name]))
        if max_molecules and len(graphs) >= max_molecules:
            break
    return graphs
