"""Port graph container (kagnn_tpu_torch/graphs/batch.py) against the JAX
`single_graph`, field by field, plus the CSR row pointers the Hopper kernels
walk."""
import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph

torch.set_num_threads(1)

FIELDS = ("senders", "receivers", "nodes", "y", "node_mask", "edge_mask",
          "senders_perm", "senders_sorted", "receivers_by_sender",
          "edge_mask_by_sender", "in_degrees")


def _random_graph(rng, n, e, f=5):
    return dict(senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
                nodes=rng.normal(size=(n, f)).astype(np.float32),
                y=rng.integers(0, 3, n).astype(np.int32), n_node=n)


CASES = {
    "random": lambda rng: (_random_graph(rng, 37, 150), {}),
    "pad_multiples": lambda rng: (_random_graph(rng, 40, 300),
                                  dict(node_pad_multiple=16,
                                       edge_pad_multiple=1024)),
    "isolated_nodes": lambda rng: (dict(_random_graph(rng, 30, 0),
                                        senders=np.array([0, 1, 2]),
                                        receivers=np.array([2, 2, 0])), {}),
    "community": lambda rng: (community_node_graph(n_nodes=50, seed=1), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_graph_matches_jax(rng, case):
    d, kw = CASES[case](rng)
    args = (d["senders"], d["receivers"])
    kwargs = dict(nodes=d["nodes"], y=d["y"], n_node=d["n_node"], **kw)
    gj = jax_single_graph(*args, **kwargs)
    gt = single_graph(*args, device="cpu", **kwargs)
    assert gt.n_node_pad == gj.n_node_pad and gt.n_edge_pad == gj.n_edge_pad
    assert gt.n_node == int(gj.n_node) and gt.n_edge == int(gj.n_edge)
    for f in FIELDS:
        a, b = getattr(gt, f).numpy(), np.asarray(getattr(gj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_row_pointers(rng, case):
    d, kw = CASES[case](rng)
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                     n_node=d["n_node"], device="cpu", **kw)
    n, e = g.n_node_pad, g.n_edge_pad
    for ptr, rows in ((g.recv_row_ptr, g.receivers),
                      (g.send_row_ptr, g.senders_sorted)):
        ptr, rows = ptr.numpy(), rows.numpy()
        assert ptr.dtype == np.int32 and ptr.shape == (n + 1,)
        assert ptr[0] == 0 and ptr[-1] == e and (np.diff(ptr) >= 0).all()
        # every edge lies in the row of its index; padded edges in the last
        row_of = np.repeat(np.arange(n), np.diff(ptr))
        np.testing.assert_array_equal(row_of, rows)
        assert np.diff(ptr)[-1] >= e - g.n_edge
    # in-degrees count valid edges only
    np.testing.assert_array_equal(
        np.bincount(g.receivers.numpy()[g.edge_mask.numpy()], minlength=n),
        g.in_degrees.numpy())


def test_graph_to_device_keeps_fields(rng):
    d = _random_graph(rng, 20, 60)
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                     device="cpu")
    h = g.to("cpu")
    assert h.n_node == g.n_node and h.n_node_pad == g.n_node_pad
    assert torch.equal(h.recv_row_ptr, g.recv_row_ptr)


def test_out_of_range_edges_raise():
    with pytest.raises(ValueError):
        single_graph(np.array([0, 5]), np.array([1, 0]), n_node=3,
                     device="cpu")
