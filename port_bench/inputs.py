"""Everything a run feeds both sides, made from `--seed`.

A traffic file's `graph.generator` names what makes a run's inputs: one of
`GENERATORS` below, or `port_bench/generators/<name>.py`, whose `make(graph,
seed, gen, device)` returns the inputs object that the program's builder
and the plain reference both take (a new kind of input, such as batches of
molecules with edge features, comes as such a file); its `num_features`
and `num_classes` size the weights (the reference module's `param_specs`).
The reference module turns it into what its `train` reads, where it
defines `reference_inputs`.

The built-in `power_receivers` graph: its edges follow a frozen copy of the
arxiv-sized generator of the port
(`kagnn_tpu_torch/data/synthetic.py::arxiv_scale_graph`): senders uniform
over the nodes, receivers `floor(n * r**power)` for r uniform in [0, 1), so
low-numbered nodes collect most in-edges (node 0 about 2,748 of 1,166,243
at the arxiv counts). The copy lives here so that a change to the program
cannot change the traffic. The node features, labels, training mask and
every weight are drawn on the device from one `torch.Generator` seeded with
the seed, in a few large calls.
"""
from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

import numpy as np
import torch

SEED_MOD = 2 ** 63  # torch generators take a seed below 2**64; the driver's may be larger than 32 bits


@dataclasses.dataclass
class GraphInputs:
    """One graph as the traffic file describes it: raw (unsorted) edges on
    the host, features, labels and the training mask on `device`."""
    senders: np.ndarray  # (E,) int32, in generation order
    receivers: np.ndarray  # (E,) int32
    nodes: torch.Tensor  # (N, F) float32
    labels: torch.Tensor  # (N,) int64
    train_mask: torch.Tensor  # (N,) bool
    n_nodes: int
    num_features: int
    num_classes: int


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)


def power_receiver_edges(graph: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The frozen edge law: (senders, receivers), int32."""
    n, e = int(graph["n_nodes"]), int(graph["n_edges"])
    rng = np.random.default_rng(int(seed) % SEED_MOD)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = np.floor(n * rng.random(e) ** float(graph["receiver_power"])).astype(np.int32)
    return snd, rcv


def power_receivers(graph: dict, seed: int, gen: torch.Generator,
                    device) -> GraphInputs:
    """One graph of the frozen edge law for `seed`; features, labels and
    mask drawn from `gen` (on `device`)."""
    snd, rcv = power_receiver_edges(graph, seed)
    n, f, c = int(graph["n_nodes"]), int(graph["num_features"]), int(graph["num_classes"])
    nodes = torch.randn((n, f), generator=gen, device=device)
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    train = torch.randperm(n, generator=gen, device=device)[:int(graph["train_nodes"])]
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[train] = True
    return GraphInputs(snd, rcv, nodes, labels, mask, n, f, c)


GENERATORS = {"power_receivers": power_receivers}


def make_inputs(graph: dict, seed: int, gen: torch.Generator, device):
    """The inputs of the traffic's `graph` for `seed`, from the built-in
    generator of that name or from `port_bench/generators/<name>.py`."""
    name = graph["generator"]
    if name in GENERATORS:
        return GENERATORS[name](graph, seed, gen, device)
    if not (Path(__file__).resolve().parent / "generators" / f"{name}.py").is_file():
        raise KeyError(f"no generator {name!r}: neither built in ({sorted(GENERATORS)}) "
                       f"nor port_bench/generators/{name}.py")
    return importlib.import_module(f"port_bench.generators.{name}").make(graph, seed, gen, device)


def reference_inputs(ref, data, device) -> dict:
    """What the reference module `ref` trains on, made from the inputs the
    program got: its `reference_inputs(data, device)` where it defines one,
    else a node task's edges (int64, raw order), features, labels and mask."""
    if hasattr(ref, "reference_inputs"):
        return ref.reference_inputs(data, device)
    return {"senders": torch.from_numpy(data.senders).long().to(device),
            "receivers": torch.from_numpy(data.receivers).long().to(device),
            "nodes": data.nodes, "labels": data.labels, "train_mask": data.train_mask}


def make_weights(specs, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """One f32 tensor per (name, shape, bound) of `specs`: U(-bound, bound)
    from a single draw on `device`; a bound given as ("const", v) fills the
    leaf with v (BatchNorm's ones and zeros, a bias's zeros)."""
    drawn = [(n, s, b) for n, s, b in specs if not isinstance(b, tuple)]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, bound in specs:
        if isinstance(bound, tuple):
            out[name] = torch.full(shape, float(bound[1]), device=device)
            continue
        size = int(np.prod(shape))
        out[name] = flat[at:at + size].view(shape) * float(bound)
        at += size
    return out
