"""`BENCHMARK.json` and the files it names by name.

A cell (`workloads` entry) names a configuration and a traffic mix. The
harness finds
  * the configuration at the `file` its `configs` entry gives,
  * the traffic at `port_bench/traffic/<traffic>.json`,
  * the cell's correctness limits at `port_bench/cells/<cell>.json`,
  * each per-layer metric's reader at `port_bench/metrics/<metric>.py`,
so a later change adds a cell, a configuration, a traffic mix or a metric
with new files and new entries alone.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = REPO) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def resolve(bench: dict, cell_name: str, root: Path = REPO) -> dict:
    """The cell's entry, configuration, traffic and limits, and the
    metrics it reports: {"cell", "config", "traffic", "limits",
    "end_to_end", "per_layer"}. Raises KeyError for an unknown cell."""
    root = Path(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / bench["paths"][0]

    def reports(metric):
        return cell_name in metric.get("workloads", [cell_name])

    return {"cell": cell,
            "config": _json(root / conf["file"]),
            "traffic": _json(here / "traffic" / f"{cell['traffic']}.json"),
            "limits": _json(here / "cells" / f"{cell_name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def reader(name: str, bench: dict, root: Path = REPO):
    """The `read(ctx)` function of the per-layer metric `name`."""
    path = Path(root) / bench["paths"][0] / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
