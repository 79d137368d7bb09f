"""The plain reference agrees with the port's CPU path (its kernels' plain
versions) in float32 at a small size, and imports nothing of the program."""
import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench import calibrate, check, inputs, manifest, program, run

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


# the captured entry's steps are eager steps replayed: the test runs those
EAGER = {"make_node_multi_step": "make_node_steps"}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port_in_f32(cell, tiny):
    """The configuration's reference (the module its `"reference"` names)
    and the port's step entry, as the traffic names it, at the traffic's
    learning rate: 3 units from the same weights."""
    r = manifest.resolve(BENCH, cell)
    ref = manifest.reference(r["config"])
    config = {**r["config"], "compute_dtype": "float32"}
    traffic = {**r["traffic"], "optimizer": {**r["traffic"]["optimizer"], "capturable": False}}
    if traffic["entry"] in EAGER:
        traffic.update(entry=EAGER[traffic["entry"]], unit_steps=1)
    dev = torch.device("cpu")
    gen = inputs.generator(2 ** 40 + 7, dev)
    data = inputs.make_inputs({**traffic["graph"], **tiny}, 2 ** 40 + 7, gen, dev)
    weights = inputs.make_weights(
        ref.param_specs(config, data.num_features, data.num_classes), gen, dev)
    prog = program.build(config, traffic, data, weights, dev)
    first = run.first_units(prog, 3)
    rdata = inputs.reference_inputs(ref, data, dev)
    losses, grads, params = ref.train(weights, rdata, config, traffic["optimizer"]["lr"],
                                      len(first["losses"]), prog.unit_steps)
    torch.testing.assert_close(torch.tensor(first["losses"]), torch.tensor(losses),
                               rtol=1e-5, atol=0)
    for k in grads:
        torch.testing.assert_close(first["grads"][k], grads[k], rtol=1e-4, atol=1e-7)
    # Adam moves an element whose gradient is near 0 by up to lr whatever its
    # sign, so the parameters are compared by each leaf's change
    g = check.gaps(first, {"losses": losses, "grads": grads, "params": params}, weights)
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-3 and g["change_gap"] < 1e-3, g


def imports_of_the_program(root=manifest.REPO) -> list[str]:
    """What of the port, of JAX or of the JAX package a process loads that
    imports every reference module and input generator under `root`'s
    `port_bench/`, with the inputs, the counts and every metric reader."""
    here = root / "port_bench"
    mods = ["port_bench.inputs", "port_bench.work", "port_bench.check"] + [
        f"port_bench.{d}.{p.stem}" for d in ("reference", "generators")
        for p in sorted((here / d).glob("*.py")) if p.stem != "__init__"]
    code = (f"import importlib, json, runpy, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"for p in {[str(p) for p in sorted((here / 'metrics').glob('*.py'))]!r}: "
            f"runpy.run_path(p)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'kagnn_tpu_torch', 'kagnn_tpu', 'jax', 'jaxlib', 'flax'})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=root, env={**os.environ, "PYTHONPATH": str(root)})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    """Every reference module and input generator, the counts and the metric
    readers import nothing of the port; only `program.py` and
    `programs/*.py` name it."""
    assert imports_of_the_program() == []
    for d in ("reference", "generators"):
        for path in (manifest.HERE / d).glob("*.py"):
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
