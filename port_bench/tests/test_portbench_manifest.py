"""BENCHMARK.json parses and keeps the contract's rules; each cell finds its
configuration, traffic, limits and metric readers by name; a new cell is
taken from new files and entries alone."""
import json
import re
import shutil

import pytest

from port_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def problems(bench: dict) -> list[str]:
    """What in `bench` breaks the benchmark contract's rules on names,
    units, lines and references; empty when nothing does."""
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(bench) != keys:
        out.append(f"top-level keys {sorted(bench)} are not {sorted(keys)}")
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench.get(group, []):
            if not NAME.match(e.get("name", "")):
                out.append(f"{group}: bad name {e.get('name')!r}")
            kind = "metric" if group in ("end_to_end", "per_layer") else group
            if (kind, e["name"]) in names:
                out.append(f"{group}: {e['name']} named twice")
            names[(kind, e["name"])] = e
    confs = {c["name"] for c in bench.get("configs", [])}
    for c in bench.get("configs", []):
        for k in c.get("reduced", []):
            if not NAME.match(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
        for k in ("source", "why"):
            if not LINE.match(c.get(k, "")):
                out.append(f"config {c['name']}: bad {k}")
        if not c["file"].startswith(bench["paths"][0] + "/"):
            out.append(f"config {c['name']}: file outside paths")
    pairs = set()
    for w in bench.get("workloads", []):
        if w["config"] not in confs:
            out.append(f"workload {w['name']}: unknown config {w['config']!r}")
        if not NAME.match(w["traffic"]):
            out.append(f"workload {w['name']}: bad traffic {w['traffic']!r}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: config and traffic pair repeated")
        pairs.add((w["config"], w["traffic"]))
        if w.get("chips") not in (1, 4) or not LINE.match(w.get("why", "")):
            out.append(f"workload {w['name']}: bad chips or why")
    cells = {w["name"] for w in bench.get("workloads", [])}
    e2e = {m["name"] for m in bench.get("end_to_end", [])}
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        if not UNIT.match(m.get("unit", "")) or m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']}: bad unit or better")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"metric {m['name']}: unknown workload {w!r}")
    for m in bench.get("end_to_end", []):
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"metric {m['name']}: end-to-end source {m.get('source')!r}")
        if not 0 < m.get("bound", 0) <= 0.25:
            out.append(f"metric {m['name']}: bound out of (0, 0.25]")
    for m in bench.get("per_layer", []):
        if m.get("moves") not in e2e or not LINE.match(m.get("layer", "")):
            out.append(f"metric {m['name']}: bad moves or layer")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    return out


BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_keeps_the_contract():
    assert problems(BENCH) == []
    for name in ([c["name"] for c in BENCH["configs"]] + CELLS
                 + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]):
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
    assert BENCH["command"][:3] == ["python3", "-m", "port_bench.run"]
    assert BENCH["paths"] == ["port_bench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    r = manifest.resolve(BENCH, cell)
    assert r["config"]["name"] == r["cell"]["config"]
    assert {"graph", "entry", "unit_steps", "optimizer", "check_units",
            "trace_units"} <= set(r["traffic"])
    assert r["limits"]["limits"]
    assert {m["name"] for m in r["end_to_end"]} >= {"setup_s", "step_ms"}
    for m in r["per_layer"]:
        assert callable(manifest.reader(m["name"], BENCH))


def test_new_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix and a cell added as new files and new
    entries are found; no file that was there changes."""
    shutil.copy(manifest.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "out"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    here = tmp_path / "port_bench"
    conf = json.loads((here / "configs" / "kagin.json").read_text())
    conf.update(name="kagin-wide", hidden_channels=128)
    (here / "configs" / "kagin-wide.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic" / "arxiv-eager.json").read_text())
    traffic["graph"].update(n_nodes=1000, n_edges=5000)
    (here / "traffic" / "small-eager.json").write_text(json.dumps(traffic))
    (here / "cells" / "kagin-wide.small-eager.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.5}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "kagin-wide",
                             "file": "port_bench/configs/kagin-wide.json"})
    bench["workloads"].append({"name": "kagin-wide.small-eager", "config": "kagin-wide",
                               "traffic": "small-eager", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    r = manifest.resolve(manifest.load(tmp_path), "kagin-wide.small-eager", tmp_path)
    assert r["config"]["hidden_channels"] == 128
    assert r["traffic"]["graph"]["n_nodes"] == 1000
    assert r["limits"]["limits"] == {"loss_gap": 0.5}
    # every per-layer metric reaches the new cell without an edit to its entry
    assert [m["name"] for m in r["per_layer"]] == [m["name"] for m in bench["per_layer"]]
    assert problems(manifest.load(tmp_path)) == []
    assert all(p.read_bytes() == b for p, b in before.items())


def test_problems_names_a_bad_name_and_unit():
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"][0]["name"] = "step ms"
    bench["per_layer"][0]["unit"] = "ms per step"
    found = problems(bench)
    assert any("bad name 'step ms'" in p for p in found)
    assert any("bad unit" in p for p in found)
