"""The port's padded multi-graph batching (kagnn_tpu_torch/graphs/batch.py,
data/native.py, train/experiments.py::batch_loader, train/prefetch.py)
against the JAX package's `batch_graphs`, field by field and bit for bit:
with and without edge features, shuffled selections and a batch that
fills its PadSpec; the three CSR row pointers against searchsorted; the
errors; the loader's batches for a seed; prefetch on the CPU."""
import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs.batch import PadSpec as JaxPadSpec
from kagnn_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from kagnn_tpu.graphs.batch import pad_spec_for as jax_pad_spec_for
from kagnn_tpu.train.experiments import batch_loader as jax_batch_loader
from kagnn_tpu_torch.data import random_molecule_graphs
from kagnn_tpu_torch.data.native import NativeBatchAssembler
from kagnn_tpu_torch.data.native import _lib_path as native_lib_path
from kagnn_tpu_torch.graphs import PadSpec, batch_graphs, pad_spec_for
from kagnn_tpu_torch.train.experiments import batch_loader
from kagnn_tpu_torch.train.prefetch import prefetch_to_device

torch.set_num_threads(1)

FIELDS = ("senders", "receivers", "nodes", "edges", "y", "node_mask",
          "edge_mask", "graph_mask", "node_graph", "senders_perm",
          "senders_sorted", "receivers_by_sender", "edge_mask_by_sender",
          "in_degrees")
PTRS = ("recv_row_ptr", "send_row_ptr", "graph_row_ptr")


def _molecules(n=12, seed=4, onehot=False, target="classification"):
    gs = random_molecule_graphs(n, 3, 9, seed=seed, target=target)
    if onehot:
        for g in gs:
            g["nodes"] = np.eye(21, dtype=np.float32)[g["nodes"][:, 0]]
    return gs


def _no_edges(gs):
    return [{k: v for k, v in g.items() if k != "edges"} for g in gs]


def assert_same_batch(gt, gj):
    """Every JAX field bit for bit, dtype included, and the counts."""
    assert (gt.n_node, gt.n_edge, gt.n_graph) == (
        int(gj.n_node), int(gj.n_edge), int(gj.n_graph))
    for f in FIELDS:
        a, b = getattr(gt, f), getattr(gj, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def assert_row_pointers(g):
    """recv/send over their sorted edges (padding in the last row), graph
    over node_graph: each equals searchsorted, side left, with the total as
    its last entry."""
    n, e, G = g.n_node_pad, g.n_edge_pad, g.n_graph_pad
    for name, rows, count in (("recv_row_ptr", g.receivers, n),
                              ("send_row_ptr", g.senders_sorted, n),
                              ("graph_row_ptr", g.node_graph, G)):
        ptr, rows = getattr(g, name).numpy(), rows.numpy()
        assert ptr.dtype == np.int32 and ptr.shape == (count + 1,), name
        want = np.searchsorted(rows, np.arange(count + 1), side="left")
        want[-1] = rows.shape[0]
        np.testing.assert_array_equal(ptr, want, err_msg=name)
    assert g.recv_row_ptr[-1] == e and g.graph_row_ptr[-1] == n


CASES = {
    "edges": lambda: (_molecules(), slice(None)),
    "no_edges": lambda: (_no_edges(_molecules(onehot=True)), slice(None)),
    "shuffled": lambda: (_molecules(), np.random.default_rng(0).permutation(12)[:7]),
    "regression": lambda: (_molecules(target="regression"), [3, 1, 8, 0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_graphs_matches_jax(case):
    gs, sel = CASES[case]()
    spec = pad_spec_for(gs, 8)
    jspec = jax_pad_spec_for(gs, 8)
    assert (spec.n_node, spec.n_edge, spec.n_graph) == (
        jspec.n_node, jspec.n_edge, jspec.n_graph)
    chosen = [gs[i] for i in np.arange(len(gs))[sel]][:8]
    gt = batch_graphs(chosen, spec, device="cpu")
    assert_same_batch(gt, jax_batch_graphs(chosen, jspec))
    assert_row_pointers(gt)


def test_batch_that_fills_its_spec():
    """n_node = n_node_pad - 1 (the last graph ends one row before the only
    pad node), every edge slot used, every graph slot but the padding one:
    the pad graph holds one node and the pad row no padded edge."""
    gs = _molecules(5)
    n = sum(g["n_node"] for g in gs)
    e = sum(len(g["senders"]) for g in gs)
    gt = batch_graphs(gs, PadSpec(n + 1, e, 6), device="cpu")
    assert_same_batch(gt, jax_batch_graphs(gs, JaxPadSpec(n + 1, e, 6)))
    assert_row_pointers(gt)
    assert gt.n_node == gt.n_node_pad - 1 and gt.n_edge == gt.n_edge_pad
    assert gt.graph_row_ptr.tolist()[-2:] == [n, n + 1]


@pytest.mark.parametrize("sel", [range(12), [5, 0, 11, 2, 7], [4]],
                         ids=["all", "shuffled", "one"])
def test_native_assembler_matches_jax(sel):
    """The native assembler gathers features as float32, as the JAX one."""
    gs = _no_edges(_molecules(onehot=True))
    spec = pad_spec_for(gs, 12)
    jspec = jax_pad_spec_for(gs, 12)
    nat = NativeBatchAssembler(gs, spec)
    gt = nat.assemble(list(sel), device="cpu")
    assert_same_batch(gt, jax_batch_graphs([gs[i] for i in sel], jspec))
    assert_row_pointers(gt)
    ref = batch_graphs([gs[i] for i in sel], spec, device="cpu")
    for f in PTRS:
        assert torch.equal(getattr(gt, f), getattr(ref, f)), f
    # built from the port's own copy into the port's build directory
    assert native_lib_path().parent.name == "_build"
    assert native_lib_path().parent.parent.name == "kagnn_tpu_torch"


def test_native_assembler_fills_its_spec():
    gs = _no_edges(_molecules(5, onehot=True))
    n = sum(g["n_node"] for g in gs)
    e = sum(len(g["senders"]) for g in gs)
    gt = NativeBatchAssembler(gs, PadSpec(n + 1, e, 6)).assemble(
        range(5), device="cpu")
    assert_same_batch(gt, jax_batch_graphs(gs, JaxPadSpec(n + 1, e, 6)))
    assert_row_pointers(gt)


def test_errors_as_in_jax():
    """Out-of-range indices raise ValueError, an oversize batch fails the
    size assertion (batch_graphs) or raises (native), edge features are
    refused natively."""
    gs = _molecules(4)
    bad = [dict(gs[0], receivers=gs[0]["receivers"] + 1)] + gs[1:]
    spec = pad_spec_for(gs, 4)
    with pytest.raises(ValueError, match="out of range"):
        jax_batch_graphs(bad, jax_pad_spec_for(gs, 4))
    with pytest.raises(ValueError, match="out of range"):
        batch_graphs(bad, spec, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        NativeBatchAssembler(_no_edges(bad), spec)
    small = PadSpec(spec.n_node // 2, spec.n_edge, spec.n_graph)
    with pytest.raises(AssertionError, match="exceeds PadSpec"):
        batch_graphs(gs, small, device="cpu")
    with pytest.raises(AssertionError, match="larger than"):
        batch_graphs(gs, PadSpec(spec.n_node, spec.n_edge, 4), device="cpu")
    with pytest.raises(ValueError, match="exceeds PadSpec"):
        NativeBatchAssembler(_no_edges(gs), small).assemble(range(4), device="cpu")
    with pytest.raises(ValueError, match="edge features"):
        NativeBatchAssembler(gs, spec)


@pytest.mark.parametrize("sel", [[0, -1], [1, 4], [7]],
                         ids=["negative", "one-past", "far"])
def test_native_assembler_refuses_selections_outside_the_dataset(sel):
    """A graph index outside [0, len(graphs)) raises ValueError before the
    C++ reads the dataset arrays at it (the numpy batcher's list indexing
    raises IndexError for it)."""
    gs = _no_edges(_molecules(4, onehot=True))
    asm = NativeBatchAssembler(gs, pad_spec_for(gs, 4))
    with pytest.raises(ValueError, match="out of range"):
        asm.assemble(sel, device="cpu")
    asm.assemble([3, 0], device="cpu")  # still usable


@pytest.mark.parametrize("native,edges", [(False, True), (True, False),
                                          (None, False), (None, True)],
                         ids=["numpy", "native", "auto-native", "auto-numpy"])
def test_batch_loader_matches_jax(native, edges):
    """Two shuffled passes of the port's loader give the JAX numpy loader's
    batches for the same seed (the native assembler is bit-identical)."""
    gs = _molecules(10, onehot=True)
    if not edges:
        gs = _no_edges(gs)
    spec = pad_spec_for(gs, 4)
    jspec = jax_pad_spec_for(gs, 4)
    ours = batch_loader(gs, spec, 4, shuffle=True, seed=7, native=native,
                        device="cpu")
    theirs = jax_batch_loader(gs, jspec, 4, shuffle=True, seed=7, native=False)
    for _ in range(2):
        got, want = list(ours()), list(theirs())
        assert len(got) == len(want) == 3
        for gt, gj in zip(got, want):
            assert_same_batch(gt, gj)
            assert_row_pointers(gt)
    with pytest.raises(ValueError, match="edge features"):
        batch_loader(_molecules(4), pad_spec_for(_molecules(4), 2), 2,
                     native=True, device="cpu")


def test_prefetch_on_the_cpu_keeps_order_and_reraises():
    gs = _molecules(9)
    spec = pad_spec_for(gs, 2)
    ours = batch_loader(gs, spec, 2, shuffle=True, seed=3, prefetch=2,
                        device="cpu")
    plain = batch_loader(gs, spec, 2, shuffle=True, seed=3, device="cpu")
    got, want = list(ours()), list(plain())
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.n_graph == b.n_graph
        for ta, tb in zip(a.tensors(), b.tensors()):
            assert torch.equal(ta, tb)

    def failing():
        yield batch_graphs(gs[:2], spec, device="cpu")
        raise RuntimeError("worker failed")

    it = prefetch_to_device(failing(), size=2, device="cpu")
    assert next(it).n_graph == 2
    with pytest.raises(RuntimeError, match="worker failed"):
        next(it)
    # closing the consumer early stops the worker
    it = prefetch_to_device(iter(got), size=1, device="cpu")
    next(it)
    it.close()

