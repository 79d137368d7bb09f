"""The system under test: the port's model, its optimizer and the step
entry the traffic names. The builder is chosen by the configuration's
`"model"`: `port_bench/programs/<model>.py` where that file exists, else
the built-in `NodeClassifier` builder below (on the port's `GraphBatch`).
This module and those files are the only modules of the benchmark that
import `kagnn_tpu_torch`.
"""
from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path
from typing import Callable

import torch

from port_bench.inputs import GraphInputs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class Program:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    unit: Callable[[], torch.Tensor]  # one unit of work; returns its steps' losses (k,)
    unit_steps: int

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def build(config: dict, traffic: dict, data, weights: dict[str, torch.Tensor],
          device) -> Program:
    """The configuration's program with `weights` loaded, from its builder."""
    name = config["model"]
    if (Path(__file__).resolve().parent / "programs" / f"{name}.py").is_file():
        builder = importlib.import_module(f"port_bench.programs.{name}").build
    elif name == "NodeClassifier":
        builder = build_node_classifier
    else:
        raise KeyError(f"no program builder {name!r}: port_bench/programs/{name}.py "
                       f"does not exist and it is not the built-in NodeClassifier")
    return builder(config, traffic, data, weights, device)


def load_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Fill every parameter of `model` from `weights`, which must name
    exactly its parameters."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the benchmark's weights {sorted(set(weights) ^ set(params))} "
                         f"do not match the model's parameters")
    state = model.state_dict()
    state.update(weights)
    model.load_state_dict(state)


def adam(model: torch.nn.Module, traffic: dict, device) -> torch.optim.Optimizer:
    """The traffic's optimizer over the model's parameters."""
    opt = traffic["optimizer"]
    if opt["name"] != "Adam":
        raise ValueError(f"unknown optimizer {opt['name']!r}")
    # capturable Adam keeps its step count on the card; the CPU (the tests'
    # small runs) has no such mode
    capturable = bool(opt.get("capturable", False)) and torch.device(device).type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=opt["lr"], capturable=capturable)


def build_node_classifier(config: dict, traffic: dict, data: GraphInputs,
                          weights: dict[str, torch.Tensor], device) -> Program:
    """The port's `NodeClassifier` with `weights` loaded, its optimizer, and
    the unit of work of the traffic's step entry, bound to the graph and
    mask."""
    from kagnn_tpu_torch.graphs.batch import single_graph
    from kagnn_tpu_torch.models.node import NodeClassifier
    from kagnn_tpu_torch.train.loops import make_node_multi_step, make_node_steps

    g = single_graph(data.senders, data.receivers, n_node=data.n_nodes, device=device)
    pad = g.n_node_pad - data.n_nodes
    nodes = torch.cat([data.nodes, data.nodes.new_zeros((pad, data.num_features))])
    labels = torch.cat([data.labels, data.labels.new_zeros(pad)]).to(torch.int32)
    mask = torch.cat([data.train_mask, data.train_mask.new_zeros(pad)])
    g = g.replace(nodes=nodes, y=labels)

    model = NodeClassifier(
        config["conv_type"], config["architecture"], config["mp_layers"],
        data.num_features, config["hidden_channels"], data.num_classes,
        skip=config["skip"], grid_size=config["grid_size"],
        spline_order=config["spline_order"], hidden_layers=config["hidden_layers"],
        dropout=config["dropout"], heads=config.get("heads", 1), fused=config["fused"],
        compute_dtype=DTYPES[config["compute_dtype"]], device=device)
    load_weights(model, weights)
    optimizer = adam(model, traffic, device)
    steps = int(traffic["unit_steps"])
    entry = traffic["entry"]
    if entry == "make_node_steps" and steps == 1:
        train_step, _ = make_node_steps(model, optimizer)
        unit = lambda: train_step(g, mask).reshape(1)  # noqa: E731
    elif entry == "make_node_multi_step":
        multi = make_node_multi_step(model, optimizer, steps)
        unit = lambda: multi(g, mask)  # noqa: E731
    else:
        raise ValueError(f"unknown step entry {entry!r} with {steps} steps a unit")
    return Program(model, optimizer, unit, steps)
