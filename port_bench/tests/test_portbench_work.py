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


ARXIV = {"n_nodes": 169343, "n_edges": 1166243, "num_features": 128, "num_classes": 40}
PRODUCTS = {"n_nodes": 2449029, "n_edges": 123718280, "num_features": 100, "num_classes": 47}
# (items, bytes, operations) of kan_layer and of message_passing, and
# model_flops, as the counts read before a configuration could bring its own
PINNED = {
    ("kagin", "arxiv"): ((14, 765597280, 231672061952), (5, 286822588, 447837312),
                         232119899264.0),
    ("kagin", "products"): ((14, 10845756332, 3262655210496), (5, 6010763496, 44043707680),
                            3306698918176.0),
    ("kagat", "arxiv"): ((8, 1422748000, 1326218510336), (6, 1381379112, 5541986736),
                         1333321162160.0),
    ("kagat", "products"): ((8, 20256707756, 18828605165568), (6, 22541878512, 587909266560),
                            19439084683392.0),
}


def _totals(items):
    return (len(items), sum(b for b, _ in items), sum(o for _, o in items))


@pytest.mark.parametrize("config,graph", sorted(PINNED))
def test_counts_of_the_cells_are_pinned(config, graph):
    import json

    from port_bench import manifest

    conf = json.loads((manifest.HERE / "configs" / f"{config}.json").read_text())
    g = {"arxiv": ARXIV, "products": PRODUCTS}[graph]
    kan, mp, flops = PINNED[(config, graph)]
    assert _totals(work.kan_layer(conf, g)) == kan
    assert _totals(work.message_passing(conf, g)) == mp
    assert work.model_flops(conf, g) == flops


@pytest.mark.parametrize("change", [{"conv_type": "gcn"}, {"architecture": "fastkan"},
                                    {"architecture": "mlp"}, {"model": "GraphRegressor"}])
def test_a_count_that_does_not_apply_is_none(change):
    """The built-in counts cover B-spline GIN and GAT node classifiers;
    another model, conv or update, without counts of its own, gets None
    and no error (a FastKAN layer is never counted as B-spline products)."""
    conf = {**GAT, "architecture": "kan", **change}
    assert work.kan_layer(conf, GRAPH) is None
    assert work.message_passing(conf, GRAPH) is None
    assert work.model_flops(conf, GRAPH) is None
