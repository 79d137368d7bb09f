"""A configuration of a model that no cell runs, with its own reference (and
builder and inputs' generator), passes the benchmark's own per-cell and
per-configuration tests as new files alone: in a copy of the benchmark and
its tests with both samples of `new_config/` added as cells, those tests of
`test_portbench_reference.py`, `test_portbench_blocked.py`,
`test_portbench_run.py` and `test_portbench_manifest.py` run in a process of
their own on the samples' cells and pass; pointed at a reference that is not
its model's, the KAGCN sample fails `test_reference_follows_the_port_in_f32`."""
import json
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

from port_bench import manifest
from port_bench.tests.samples import SAMPLES, add_samples, copy_benchmark

FILES = ["test_portbench_reference.py", "test_portbench_blocked.py", "test_portbench_run.py",
         "test_portbench_manifest.py"]
# the per-cell and per-configuration tests each sample must pass, at least
PER_CELL = {"test_reference_follows_the_port_in_f32", "test_control_fails_the_cell_limits",
            "test_sound_run_is_correct", "test_broken_step_is_not_correct",
            "test_cell_finds_its_files_by_name"}
PER_CONFIG = {"test_edge_blocks_are_bit_for_bit", "test_kan_row_blocks_within_round_off"}

# a pytest plugin that keeps the cases whose `cell` or `config` parameter
# names one of the samples
SELECT = '''
import json, os

CELLS, CONFIGS = json.loads(os.environ["PORT_BENCH_SAMPLES"])


def pytest_collection_modifyitems(config, items):
    def ours(item):
        params = getattr(getattr(item, "callspec", None), "params", {})
        return params.get("cell") in CELLS or params.get("config") in CONFIGS

    config.hook.pytest_deselected(items=[i for i in items if not ours(i)])
    items[:] = [i for i in items if ours(i)]
'''


def _pytest(root, configs, tests=FILES) -> dict:
    """Run `tests` (files or node ids under `port_bench/tests/`) in the copy
    at `root` on the cases of the samples `configs`, in a process of its
    own; {test id: "passed", "failed" or "skipped"} and the output's end."""
    (root / "select_samples.py").write_text(SELECT)
    cells = [SAMPLES[c][0] for c in configs]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(manifest.REPO)]),
           "PORT_BENCH_SAMPLES": json.dumps([cells, list(configs)])}
    xml = root / "results.xml"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "select_samples", f"--junitxml={xml}"]
        + [f"port_bench/tests/{t}" for t in tests],
        capture_output=True, text=True, cwd=root, env=env, timeout=1500)
    outcomes = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        kinds = {child.tag for child in case} & {"failure", "error", "skipped"}
        outcomes[case.get("name")] = ("skipped" if kinds == {"skipped"} else
                                      "failed" if kinds else "passed")
    return {"outcomes": outcomes, "rc": out.returncode, "tail": (out.stdout + out.stderr)[-6000:]}


def test_samples_pass_the_per_cell_tests(tmp_path):
    copy_benchmark(tmp_path, tests=True)
    add_samples(tmp_path)
    got = _pytest(tmp_path, list(SAMPLES))
    outcomes = got["outcomes"]
    assert got["rc"] == 0 and outcomes, got["tail"]
    assert all(v == "passed" for v in outcomes.values()), (outcomes, got["tail"])
    for config, (cell, *_) in SAMPLES.items():
        ran = {name.split("[")[0] for name in outcomes if f"[{cell}" in name}
        assert ran >= PER_CELL, (cell, sorted(ran))
        ran = {name.split("[")[0] for name in outcomes if name.endswith(f"[{config}]")}
        assert ran >= PER_CONFIG, (config, sorted(ran))


MUTATED = "sample_kan_gcn_node_two_self_loops"


@pytest.mark.parametrize("wrong", ["kan_node", MUTATED])
def test_another_reference_fails_the_reference_test(tmp_path, wrong):
    """The KAGCN sample's `"reference"` pointed at `kan_node` (GIN and GAT
    only: it raises), or at a copy of its own reference that counts each
    node's self-loop twice in GCN's degree (its numbers move): the
    reference test fails for that cell."""
    copy_benchmark(tmp_path, tests=True)
    add_samples(tmp_path, ["sample-kagcn"])
    config = tmp_path / "port_bench" / "configs" / "sample-kagcn.json"
    config.write_text(json.dumps({**json.loads(config.read_text()), "reference": wrong}))
    here = tmp_path / "port_bench" / "reference"
    own = (here / "sample_kan_gcn_node.py").read_text()
    mutated = own.replace(") + 1.0)[:, None]", ") + 2.0)[:, None]")
    assert mutated != own
    (here / f"{MUTATED}.py").write_text(mutated)
    got = _pytest(tmp_path, ["sample-kagcn"], ["test_portbench_reference.py::"
                                               "test_reference_follows_the_port_in_f32"])
    assert got["rc"] == 1 and list(got["outcomes"].values()) == ["failed"], got
    expected = ("no reference for conv_type 'gcn'" if wrong == "kan_node"
                else "Tensor-likes are not close")
    assert expected in got["tail"], got["tail"]


def test_samples_take_the_benchmarks_builder_and_fail_another_collision(tmp_path):
    """Where the benchmark already holds a builder of the sample's model, the
    sample runs on it and copies none of its own; a file of any other kind
    under a sample's name fails."""
    copy_benchmark(tmp_path)
    builder = tmp_path / "port_bench" / "programs" / "GraphRegressor.py"
    builder.write_text("# the benchmark's own\n")
    add_samples(tmp_path, ["sample-kagine"])
    assert builder.read_text() == "# the benchmark's own\n"
    assert (tmp_path / "port_bench" / "generators" / "molecules.py").is_file()
    again = tmp_path / "again"
    again.mkdir()
    copy_benchmark(again)
    (again / "port_bench" / "configs" / "sample-kagcn.json").write_text("{}")
    with pytest.raises(AssertionError, match="sample-kagcn.json"):
        add_samples(again, ["sample-kagcn"])
