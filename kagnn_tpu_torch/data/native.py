"""The native (C++) batch assembler, the counterpart of
`kagnn_tpu/data/native.py::NativeBatchAssembler`.

The graph tasks build a fresh padded `GraphBatch` on the host every step.
`csrc/host/batcher.cpp` (the port's copy of the JAX package's batcher)
does it in one pass over dataset arrays concatenated once: block-diagonal
relabeling, the counting sort by receiver, the counting sort by sender,
masks, segment ids and feature gathering. The rest of the port's GraphBatch
(the in-degrees, the receivers and mask in sender order, the three CSR row
pointers) is derived in numpy by `graphs/batch.py::_assemble`, as for every
batch. The library is bound with ctypes and built by g++ at its first use
(never at import) into `kagnn_tpu_torch/_build/`, named by a hash of its
source and flags; a failed build raises.

`NativeBatchAssembler.assemble(sel)` equals `batch_graphs` of the same
graphs bit for bit, with the JAX assembler's one difference: node features
are gathered as float32 whatever their dtype.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from kagnn_tpu_torch.graphs.batch import GraphBatch, PadSpec, _assemble
from kagnn_tpu_torch.utils.device import resolve_device

PKG = Path(__file__).resolve().parent.parent
SRC = PKG / "csrc" / "host" / "batcher.cpp"
BUILD = PKG / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"batcher-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The batcher library, built by g++ first if needed; raises when the
    build fails."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        out = _lib_path()
        if not out.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"building the native batcher failed: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for the native batcher "
                                   f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.assemble_batch.restype = ctypes.c_int
        lib.assemble_batch.argtypes = [
            i32p, i32p,                          # senders, receivers
            i64p, i64p,                          # edge_offsets, node_counts
            f32p, i64p, ctypes.c_int64,          # node_feat, offsets, feat_dim
            i64p, ctypes.c_int64,                # sel, n_sel
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # pads
            i32p, i32p, u8p,                     # snd, rcv, edge_mask
            u8p, i32p, f32p,                     # node_mask, node_graph, feat
            i32p, i32p,                          # perm, snd_sorted
            i64p,                                # counts
        ]
        lib.degree_onehot.restype = None
        lib.degree_onehot.argtypes = [i32p, i64p, i64p, i64p, ctypes.c_int64,
                                      ctypes.c_int64, f32p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBatchAssembler:
    """Assemble padded `GraphBatch`es natively from a fixed dataset.

    `graphs`: dicts with 'senders'/'receivers'/'n_node', optional 'nodes'
    (gathered as float32) and 'y'. Edge features are refused, as by the JAX
    assembler: the receiver sort happens in C++ and would need a returned
    permutation; `batch_graphs` takes them."""

    def __init__(self, graphs: Sequence[dict], spec: PadSpec):
        if any(g.get("edges") is not None for g in graphs):
            raise ValueError("edge features unsupported natively; "
                             "use batch_graphs")
        self._lib = load()
        self.spec = spec
        n_graphs = len(graphs)
        self._node_counts = np.fromiter(
            (int(g["n_node"]) for g in graphs), np.int64, n_graphs)
        snd = [np.asarray(g["senders"], np.int32) for g in graphs]
        rcv = [np.asarray(g["receivers"], np.int32) for g in graphs]
        self._edge_offsets = np.zeros(n_graphs + 1, np.int64)
        np.cumsum([s.shape[0] for s in snd], out=self._edge_offsets[1:])
        self._senders = np.concatenate(snd) if snd else np.zeros(0, np.int32)
        self._receivers = np.concatenate(rcv) if rcv else np.zeros(0, np.int32)
        for gid, (s, r, n) in enumerate(zip(snd, rcv, self._node_counts)):
            if s.size and (int(s.min()) < 0 or int(s.max()) >= n
                           or int(r.min()) < 0 or int(r.max()) >= n):
                raise ValueError(
                    f"graph {gid}: edge indices out of range [0, {n})")

        self._node_feat_offsets = np.zeros(n_graphs + 1, np.int64)
        np.cumsum(self._node_counts, out=self._node_feat_offsets[1:])
        if graphs and graphs[0].get("nodes") is not None:
            self._feat = np.ascontiguousarray(
                np.concatenate([np.asarray(g["nodes"]) for g in graphs]),
                np.float32)
            self._feat_dim = int(self._feat.shape[1])
        else:
            self._feat = np.zeros((int(self._node_feat_offsets[-1]), 0),
                                  np.float32)
            self._feat_dim = 0
        self._ys = ([np.asarray(g["y"]).reshape(1, -1) for g in graphs]
                    if graphs and graphs[0].get("y") is not None else None)

    def assemble(self, sel: Sequence[int], device=None) -> GraphBatch:
        """The padded batch of graphs `sel` on `device` (CUDA unless told
        otherwise). Raises ValueError for an index outside the dataset
        (the C++ reads the dataset arrays at it unchecked)."""
        dev = resolve_device(device)
        spec = self.spec
        n, e, g = spec.n_node, spec.n_edge, spec.n_graph
        sel_arr = np.ascontiguousarray(sel, np.int64)
        n_graphs = self._node_counts.shape[0]
        if sel_arr.size and (int(sel_arr.min()) < 0 or int(sel_arr.max()) >= n_graphs):
            raise ValueError(f"graph indices out of range [0, {n_graphs}): "
                             f"[{sel_arr.min()}, {sel_arr.max()}]")
        snd, rcv = np.empty(e, np.int32), np.empty(e, np.int32)
        edge_mask, node_mask = np.empty(e, np.uint8), np.empty(n, np.uint8)
        node_graph = np.empty(n, np.int32)
        feat = np.empty((n, self._feat_dim), np.float32)
        perm, snd_sorted = np.empty(e, np.int32), np.empty(e, np.int32)
        counts = np.empty(3, np.int64)
        i32, u8 = ctypes.c_int32, ctypes.c_uint8
        rc = self._lib.assemble_batch(
            _ptr(self._senders, i32), _ptr(self._receivers, i32),
            _ptr(self._edge_offsets, ctypes.c_int64),
            _ptr(self._node_counts, ctypes.c_int64),
            _ptr(self._feat, ctypes.c_float),
            _ptr(self._node_feat_offsets, ctypes.c_int64), self._feat_dim,
            _ptr(sel_arr, ctypes.c_int64), sel_arr.shape[0], n, e, g,
            _ptr(snd, i32), _ptr(rcv, i32), _ptr(edge_mask, u8),
            _ptr(node_mask, u8), _ptr(node_graph, i32),
            _ptr(feat, ctypes.c_float), _ptr(perm, i32), _ptr(snd_sorted, i32),
            _ptr(counts, ctypes.c_int64))
        if rc != 0:
            raise ValueError(
                f"selection of {sel_arr.shape[0]} graphs exceeds PadSpec {spec}")

        y = None
        if self._ys is not None:
            yv = np.concatenate([self._ys[i] for i in sel_arr])
            pad = np.zeros((g - yv.shape[0],) + yv.shape[1:], yv.dtype)
            y = np.concatenate([yv, pad])
            if y.shape[-1] == 1:
                y = y[..., 0]
        return _assemble(
            dev, snd, rcv, feat if self._feat_dim else None, None, y,
            node_mask.view(bool), edge_mask.view(bool),
            np.arange(g) < sel_arr.shape[0], node_graph, counts[0], counts[1],
            counts[2], perm=perm, senders_sorted=snd_sorted)


def degree_onehot_features(graphs: Sequence[dict], max_degree: int = 35
                           ) -> None:
    """Attach one-hot (clipped out-)degree node features natively, in place:
    the counterpart of `kagnn_tpu/data/native.py::degree_onehot_features`,
    the reference's `Degree` transform (graph_classification_utils.py:31-36),
    dim = max_degree + 1. Raises when the library does not build."""
    lib = load()
    n_graphs = len(graphs)
    node_counts = np.fromiter((int(g["n_node"]) for g in graphs),
                              np.int64, n_graphs)
    snd = [np.asarray(g["senders"], np.int32) for g in graphs]
    edge_offsets = np.zeros(n_graphs + 1, np.int64)
    np.cumsum([s.shape[0] for s in snd], out=edge_offsets[1:])
    senders = np.concatenate(snd) if snd else np.zeros(0, np.int32)
    feat_offsets = np.zeros(n_graphs + 1, np.int64)
    np.cumsum(node_counts, out=feat_offsets[1:])
    dim = max_degree + 1
    out = np.zeros((int(feat_offsets[-1]), dim), np.float32)
    lib.degree_onehot(
        _ptr(senders, ctypes.c_int32), _ptr(edge_offsets, ctypes.c_int64),
        _ptr(node_counts, ctypes.c_int64), _ptr(feat_offsets, ctypes.c_int64),
        n_graphs, max_degree, _ptr(out, ctypes.c_float))
    for g, lo, hi in zip(graphs, feat_offsets[:-1], feat_offsets[1:]):
        g["nodes"] = out[int(lo):int(hi)]
