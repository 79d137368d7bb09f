"""The sample configurations of `new_config/`, and how a test adds them to a
copy of the benchmark as a later change would: new files under
`port_bench/` and new `configs` and `workloads` entries in
`BENCHMARK.json`. Their names are of no real configuration's kind
(`sample-…`, `sample_…`), so that a configuration of the same model can
join the benchmark beside them; a builder and an inputs' generator are
found by the model's and the generator's own name, and where the benchmark
already holds one of those, the sample runs on the benchmark's."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from port_bench import manifest

NEW_CONFIG = manifest.HERE / "tests" / "new_config"
# by configuration: (cell, traffic, the model's class, its first conv's
# class, the builder module it brings or None for the built-in one, whether
# its reference brings the step's counts)
SAMPLES = {
    "sample-kagcn": ("sample-kagcn.sample-tiny-eager", "sample-tiny-eager", "NodeClassifier",
                     "GCNConv", None, True),
    "sample-kagine": ("sample-kagine.sample-molecules-tiny", "sample-molecules-tiny",
                      "GraphRegressor", "GINEConv", "port_bench.programs.GraphRegressor", False),
}
# the folders whose files are found by the model's or the generator's name
BY_MODEL = ("programs", "generators")


def copy_benchmark(root: Path, tests: bool = False) -> None:
    """`BENCHMARK.json` and `port_bench/` (its tests too where `tests`)
    into `root`."""
    shutil.copy(manifest.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    ignore = ["__pycache__", ".cache", "out"] + ([] if tests else ["tests"])
    shutil.copytree(manifest.HERE, root / "port_bench", ignore=shutil.ignore_patterns(*ignore))


def add_samples(root: Path, configs=tuple(SAMPLES)) -> None:
    """Every file of `new_config/` into `root`'s `port_bench/` (a builder or
    generator the benchmark already holds stays the benchmark's; any other
    file of the same name fails), and the `configs` and `workloads` entries
    of the samples `configs`."""
    for src in sorted(NEW_CONFIG.rglob("*")):
        if not src.is_file() or src.suffix not in (".py", ".json"):
            continue
        rel = src.relative_to(NEW_CONFIG)
        dst = root / "port_bench" / rel
        if dst.exists() and rel.parts[0] in BY_MODEL:
            continue
        assert not dst.exists(), dst
        shutil.copy(src, dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for config in configs:
        cell, traffic = SAMPLES[config][:2]
        bench["configs"].append({"name": config, "source": "https://arxiv.org/abs/2406.18380",
                                 "file": f"port_bench/configs/{config}.json", "reduced": [],
                                 "why": "a test"})
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
