"""The port stands alone: importing every kagnn_tpu_torch module loads no
JAX and nothing of the JAX package, the entry points refuse to carry on
quietly on the CPU when no CUDA device is present, and chip_smoke.py fails
without a card or outside the repository."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "kagnn_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "kagnn_tpu"}

_PROBE = """
import importlib, json, pkgutil, sys
import kagnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kagnn_tpu_torch.__path__,
                                                "kagnn_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["imported"]) >= 20
    bad = [m for m in res["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN.intersection(roots), (path, ast.dump(node))


def test_entry_points_need_a_device():
    """Without device="cpu" the entry points run on CUDA; on a machine with
    no CUDA device they raise instead of falling back to the CPU."""
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kan import FastKANLayer, KANLinear
    from kagnn_tpu_torch.models import NodeClassifier

    snd, rcv = np.array([0, 1]), np.array([1, 0])
    kw = dict(conv_type="gin", architecture="kan", mp_layers=1,
              num_features=4, hidden_channels=4, num_classes=2)
    gcn = dict(kw, conv_type="gcn", architecture="fastkan")
    if torch.cuda.is_available():
        assert single_graph(snd, rcv).device.type == "cuda"
        for m in (NodeClassifier(**kw), NodeClassifier(**gcn),
                  FastKANLayer(4, 2)):
            assert next(m.parameters()).device.type == "cuda"
        return
    for make in (lambda: single_graph(snd, rcv), lambda: KANLinear(4, 2),
                 lambda: FastKANLayer(4, 2), lambda: NodeClassifier(**kw),
                 lambda: NodeClassifier(**gcn)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    g = single_graph(snd, rcv, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        g.to("cuda")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs = [_run_smoke(tmp_path)]
    if not torch.cuda.is_available():
        runs.append(_run_smoke(ROOT))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
