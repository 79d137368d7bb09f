"""The operation and byte counts at a small shape, worked by hand."""
import pytest

from port_bench import work

GIN = {"conv_type": "gin", "mp_layers": 2, "hidden_channels": 4, "hidden_layers": 2,
       "grid_size": 4, "spline_order": 3, "compute_dtype": "bfloat16"}
GAT = {**GIN, "conv_type": "gat", "heads": 2}
GRAPH = {"n_nodes": 10, "n_edges": 30, "num_features": 3, "num_classes": 5}


def test_kan_layer_counts_by_hand():
    items = work.kan_layer(GIN, GRAPH)
    # layers (3->4, no dx), (4->4), (4->4), (4->4), head (4->5); 8 products a
    # weight and row; 11 knots a feature; 2 bytes a value
    assert len(items) == 10
    w = 8 * 3 * 4
    assert items[0] == (2 * (10 * 3 + 11 * 3 + w + 10 * 4), 2 * 10 * w)
    assert items[1] == (2 * (10 * 3 + 11 * 3 + 2 * w + 10 * 4), 2 * 10 * w)
    w = 8 * 4 * 4
    assert items[3] == (2 * (2 * 10 * 4 + 11 * 4 + 2 * w + 10 * 4), 4 * 10 * w)
    w = 8 * 4 * 5
    assert items[-1] == (2 * (2 * 10 * 4 + 11 * 4 + 2 * w + 10 * 5), 4 * 10 * w)


def test_message_passing_counts_by_hand():
    csr = 4 * 30 + 4 * 11
    gin = work.message_passing(GIN, GRAPH)
    # conv 0 forward only (the features need no gradient), conv 1 both ways
    assert gin == [(2 * 2 * 10 * 3 + csr, 30 * 3), (2 * 2 * 10 * 4 + csr, 30 * 4),
                   (2 * 2 * 10 * 4 + csr, 30 * 4)]
    gat = work.message_passing(GAT, GRAPH)
    hc = 8
    assert gat[0] == (2 * 2 * 10 * hc + 4 * 2 * 10 * 2 + csr, 2 * 30 * hc + 4 * 30 * 2)
    assert gat[1] == (2 * 3 * 10 * hc + 4 * 4 * 10 * 2 + csr, 4 * 30 * hc + 8 * 30 * 2)
    assert len(gat) == 4


def test_least_time_and_flops():
    assert work.least_ms([(3.35e9, 0.0)], "bfloat16") == pytest.approx(1.0)
    assert work.least_ms([(0.0, 989e9)], "bfloat16") == pytest.approx(1.0)
    assert work.least_ms([(3.35e9, 989e9 * 2)], "bfloat16") == pytest.approx(2.0)
    kan = sum(o for _, o in work.kan_layer(GAT, GRAPH))
    mp = sum(o for _, o in work.message_passing(GAT, GRAPH))
    assert work.model_flops(GAT, GRAPH) == kan + mp + 2 * 3 * 4 * 10 * 8
