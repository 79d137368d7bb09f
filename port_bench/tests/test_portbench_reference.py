"""The plain reference agrees with the port's CPU path (its kernels' plain
versions) in float32 at a small size, and imports nothing of the program."""
import subprocess
import sys

import pytest
import torch

from port_bench import calibrate, check, inputs, manifest, program, run
from port_bench.reference import kan_node

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port_in_f32(cell, tiny):
    r = manifest.resolve(BENCH, cell)
    config = {**r["config"], "compute_dtype": "float32"}
    traffic = {**r["traffic"], "entry": "make_node_steps", "unit_steps": 1,
               "optimizer": {**r["traffic"]["optimizer"], "capturable": False}}
    dev = torch.device("cpu")
    gen = inputs.generator(2 ** 40 + 7, dev)
    data = inputs.make_graph({**traffic["graph"], **tiny}, 2 ** 40 + 7, gen, dev)
    weights = inputs.make_weights(
        kan_node.param_specs(config, data.num_features, data.num_classes), gen, dev)
    prog = program.build(config, traffic, data, weights, dev)
    first = run.first_units(prog, 3)
    rdata = {"senders": torch.from_numpy(data.senders).long(),
             "receivers": torch.from_numpy(data.receivers).long(),
             "nodes": data.nodes, "labels": data.labels, "train_mask": data.train_mask}
    losses, grads, params = kan_node.train(weights, rdata, config, 1e-3, 3, 1)
    torch.testing.assert_close(torch.tensor(first["losses"]), torch.tensor(losses),
                               rtol=1e-5, atol=0)
    for k in grads:
        torch.testing.assert_close(first["grads"][k], grads[k], rtol=1e-4, atol=1e-7)
    # Adam moves an element whose gradient is near 0 by up to lr whatever its
    # sign, so the parameters are compared by each leaf's change
    g = check.gaps(first, {"losses": losses, "grads": grads, "params": params}, weights)
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-3 and g["change_gap"] < 1e-3, g


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, port_bench.reference.kan_node, port_bench.inputs, port_bench.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'kagnn_tpu_torch', 'kagnn_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=manifest.REPO)
    assert out.stdout.strip() == "[]"
    for path in (manifest.HERE / "reference").glob("*.py"):
        assert "kagnn_tpu" not in path.read_text(), path


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_limits(cell, tiny, tiny_limits):
    """The reference in float8 in the program's place, at a small size on
    the CPU, comes out not correct under the cell's limits (scaled to the
    small graph)."""
    r = manifest.resolve(BENCH, cell)
    out = calibrate.readings(r, 2 ** 33 + 5, torch.device("cpu"), kinds=("control_fp8",),
                             graph={**r["traffic"]["graph"], **tiny})
    assert not check.judge(out["control_fp8"], tiny_limits(r))
