"""The port's KAGINE: `GraphRegressor("gin", "kan")` (GINE convs, OGB
encoders, global add pooling, an L1 loss) on the traffic's batch of
molecules, one eager train step a unit."""
from __future__ import annotations

from port_bench.program import DTYPES, Program, adam, load_weights


def build(config, traffic, data, weights, device) -> Program:
    from kagnn_tpu_torch.graphs.batch import batch_graphs, pad_spec_for
    from kagnn_tpu_torch.models.regression import GraphRegressor
    from kagnn_tpu_torch.train.loops import make_graph_reg_steps

    if traffic["entry"] != "make_graph_reg_steps" or int(traffic["unit_steps"]) != 1:
        raise ValueError(f"unknown step entry {traffic['entry']!r} with "
                         f"{traffic['unit_steps']} steps a unit")
    batch = batch_graphs(data.graphs, pad_spec_for(data.graphs, len(data.graphs)),
                         device=device)
    model = GraphRegressor(
        config["conv_type"], config["architecture"], config["gnn_layers"],
        data.num_features, data.num_edge_features, config["hidden_channels"],
        data.num_classes, hidden_layers=config["hidden_layers"],
        grid_size=config["grid_size"], spline_order=config["spline_order"],
        dropout=config["dropout"], ogb_encoders=True, fused=config["fused"],
        compute_dtype=DTYPES[config["compute_dtype"]], device=device)
    load_weights(model, weights)
    optimizer = adam(model, traffic, device)
    train_step, _ = make_graph_reg_steps(model, optimizer)
    return Program(model, optimizer, lambda: train_step(batch).reshape(1), 1)
