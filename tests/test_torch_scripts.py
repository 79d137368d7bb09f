"""The port's remaining scripts, `python -m kagnn_tpu_torch.experiments.<name>`,
on the CPU (KAGNN_PLATFORM=cpu) against their JAX counterparts:

  * run_model: its summary and log line against the JAX `run_model.py` on
    the same stand-in dataset (one process: the same graph), and on an
    ogbn-arxiv file set the test writes in the raw layout;
  * time_model: the sweep's configurations and row keys of the JAX
    script, on the raw files the test writes and on the arxiv-sized
    synthetic fallback (cut to 600 nodes here);
  * time_graph_model: the JAX script's split and rows on the synthetic
    MUTAG stand-in;
  * port_checkpoint: reference-layout state_dicts that the test writes
    (efficient-kan KAN stacks with and without a standalone scaler, fastkan
    stacks with their rbf.grid) into the port's checkpoint, restored into
    the port's module, against the JAX module on the JAX porter's variables
    (f32 rtol 1e-4 / atol 1e-5);
  * train_node_synthetic, the example: its loss falls;
  * sweeps: the dry run lists the commands of the five `scripts/*.sh`
    exactly (each script run by bash with `python` echoing its arguments).
"""
import importlib.util
import json
import subprocess
import sys
import warnings
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_data as tdata
from kagnn_tpu.kan.layers import KANLinear as JKANLinear
from kagnn_tpu.kan.layers import FastKAN as JFastKAN
from kagnn_tpu.utils import port as jport
from kagnn_tpu_torch.experiments import (port_checkpoint, run_model, sweeps,
                                         time_graph_model, time_model,
                                         train_node_synthetic)
from kagnn_tpu_torch.train import checkpoint

torch.set_num_threads(1)
VAL = dict(rtol=1e-4, atol=1e-5)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("KAGNN_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_model_matches_jax_run_model(on_cpu, monkeypatch, capsys):
    """The port's summary (printed and logged) and the JAX script's: the
    same keys and hyperparameters, one test accuracy a split."""
    argv = ["--dataset", "Cora", "--architecture", "fastkan", "--conv_type", "gcn",
            "--hidden_channels", "8", "--epochs", "2", "--max_splits", "2",
            "--data_root", str(on_cpu), "--random_seed", "3"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        monkeypatch.setattr(sys, "argv", ["run_model.py"] + argv + ["--log_dir", "jax"])
        _jax_script("run_model").main()
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got = run_model.main(argv + ["--log_dir", "port"])
    assert got.keys() == want.keys() and got["params"] == want["params"]
    assert len(got["test_accs"]) == 2 and all(0 <= a <= 1 for a in got["test_accs"])
    line = json.loads((on_cpu / "port" / "Cora_fastkan_gcn").read_text())
    assert line == json.loads(json.dumps(got))


def test_run_model_on_written_files(on_cpu):
    """run_model on an ogbn-arxiv file set in the raw layout (12 nodes, the
    time split, which the registry repeats for its ten splits): one split,
    its accuracy in [0, 1]."""
    tdata.write_ogbn_arxiv(on_cpu, np.random.default_rng(0))
    res = run_model.main(["--dataset", "ogbn-arxiv", "--architecture", "kan",
                          "--conv_type", "gin", "--hidden_channels", "4", "--epochs", "3",
                          "--max_splits", "1", "--data_root", str(on_cpu),
                          "--log_dir", "logs"])
    assert res["params"]["num_features"] == 5 and len(res["test_accs"]) == 1


# the JAX script's row keys (experiments/time_model.py)
TIME_KEYS = {"arch", "conv", "hidden", "grid", "order", "sec_per_epoch", "edges_per_s"}


def test_time_model_sweeps_the_jax_configurations(on_cpu, monkeypatch):
    """The configurations the JAX script walks (an mlp without grid or
    order, a fastkan without order), its row keys, one JSON line a row, on
    the arxiv-sized synthetic fallback (cut to 600 nodes) and on an
    ogbn-arxiv file set the test writes."""
    from kagnn_tpu_torch.data import synthetic

    monkeypatch.setattr(synthetic, "arxiv_scale_graph",
                        partial(synthetic.arxiv_scale_graph, n_nodes=600, n_edges=3000))
    argv = ["--conv", "gcn", "--architectures", "mlp", "kan", "fastkan",
            "--hidden", "8", "--grids", "3", "4", "--orders", "2", "--epochs", "1",
            "--data_root", str(on_cpu)]
    rows = time_model.main(argv + ["--dataset", "ogbn-arxiv", "--out", "synth.jsonl"])
    assert [(r["arch"], r["hidden"], r["grid"], r["order"]) for r in rows] == [
        ("mlp", 8, 0, 0), ("kan", 8, 3, 2), ("kan", 8, 4, 2), ("fastkan", 8, 3, 0),
        ("fastkan", 8, 4, 0)]
    assert all(TIME_KEYS <= set(r) and r["device"] == "cpu" for r in rows)
    assert rows[0]["edges_per_s"] == pytest.approx(3000 / rows[0]["sec_per_epoch"], rel=0.01)
    assert [json.loads(l) for l in Path("synth.jsonl").read_text().splitlines()] == rows
    tdata.write_ogbn_arxiv(on_cpu, np.random.default_rng(1))
    on_disk = time_model.main(["--conv", "gcn", "--architectures", "kan", "--hidden", "4",
                               "--epochs", "1", "--dataset", "ogbn-arxiv",
                               "--data_root", str(on_cpu), "--out", "disk.jsonl"])
    from kagnn_tpu_torch.data.planetoid import load_ogbn_arxiv

    edges = load_ogbn_arxiv(str(on_cpu))["senders"].size
    assert len(on_disk) == 1 and on_disk[0]["edges_per_s"] == pytest.approx(
        edges / on_disk[0]["sec_per_epoch"], rel=0.01)


def test_time_graph_model_rows(on_cpu):
    """The JAX script's 80/10/10 split of a seeded permutation and one row a
    configuration, on the synthetic MUTAG stand-in."""
    n = 200
    idx = np.random.default_rng(4).permutation(n)
    tr, va, te = time_graph_model.split(n, 4)
    assert (np.concatenate([tr, va, te]) == idx).all() and (len(tr), len(va)) == (160, 20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rows = time_graph_model.main(["--dataset", "MUTAG", "--architecture", "kan",
                                      "--hidden_dims", "8", "--hidden_layers", "1", "2",
                                      "--epochs", "2", "--random_seed", "4",
                                      "--data_root", str(on_cpu), "--out", "g.jsonl"])
    assert [(r["hidden"], r["hidden_layers"], r["grid"], r["order"]) for r in rows] == [
        (8, 1, 4, 3), (8, 2, 4, 3)]
    assert all(1 <= r["epochs_run"] <= 2 and 0 <= r["test_acc"] <= 1 for r in rows)


def _ekan_state_dict(rng, sizes, grid, order, scaler):
    """An efficient-kan KAN stack's state_dict as the reference saves it."""
    sd = {}
    for i, (fin, fout) in enumerate(zip(sizes[:-1], sizes[1:])):
        h = 2.0 / grid
        knots = np.arange(-order, grid + order + 1) * h - 1.0
        sd[f"layers.{i}.grid"] = torch.tensor(np.tile(knots, (fin, 1)), dtype=torch.float32)
        sd[f"layers.{i}.base_weight"] = torch.tensor(rng.normal(size=(fout, fin)) * 0.3,
                                                     dtype=torch.float32)
        sd[f"layers.{i}.spline_weight"] = torch.tensor(
            rng.normal(size=(fout, fin, grid + order)) * 0.3, dtype=torch.float32)
        if scaler:
            sd[f"layers.{i}.spline_scaler"] = torch.tensor(
                rng.normal(size=(fout, fin)), dtype=torch.float32)
    return sd


def _fastkan_state_dict(rng, sizes, G, lo, hi):
    """A fastkan FastKAN stack's state_dict as the reference saves it
    (rbf.grid, the centers, beside the weights)."""
    sd = {}
    for i, (fin, fout) in enumerate(zip(sizes[:-1], sizes[1:])):
        p = f"layers.{i}."
        sd[p + "layernorm.weight"] = torch.tensor(1 + rng.normal(size=fin) * 0.1, dtype=torch.float32)
        sd[p + "layernorm.bias"] = torch.tensor(rng.normal(size=fin) * 0.1, dtype=torch.float32)
        sd[p + "rbf.grid"] = torch.linspace(lo, hi, G)
        sd[p + "spline_linear.weight"] = torch.tensor(rng.normal(size=(fout, fin * G)) * 0.3,
                                                      dtype=torch.float32)
        sd[p + "base_linear.weight"] = torch.tensor(rng.normal(size=(fout, fin)) * 0.3,
                                                    dtype=torch.float32)
        sd[p + "base_linear.bias"] = torch.tensor(rng.normal(size=fout) * 0.1, dtype=torch.float32)
    return sd


@pytest.mark.parametrize("family,case", [("kan", "scaler"), ("kan", "no_scaler"),
                                         ("fastkan", "range")])
def test_port_checkpoint_matches_the_jax_porter(on_cpu, family, case):
    """A reference state_dict written by the test -> the port's checkpoint
    (train/checkpoint.py) -> restored into the module port_checkpoint
    builds: its output equals the JAX module's on the JAX porter's
    variables (`kagnn_tpu/utils/port.py` port_kan / port_fastkan)."""
    rng = np.random.default_rng(5)
    sizes = [6, 5, 3]
    x = rng.normal(size=(20, 6)).astype(np.float32)
    if family == "kan":
        # the JAX stack has no scaler flag: its layers one by one, as the
        # JAX porter's port_kan_linear gives them
        sd = _ekan_state_dict(rng, sizes, 5, 2, case == "scaler")
        layers = [(JKANLinear(fin, fout, grid_size=5, spline_order=2,
                              enable_standalone_scale_spline=case == "scaler"),
                   jport.port_kan_linear(sd, f"layers.{i}."))
                  for i, (fin, fout) in enumerate(zip(sizes[:-1], sizes[1:]))]
        jm = None
    else:
        sd = _fastkan_state_dict(rng, sizes, 6, -1.5, 2.5)
        variables = {"params": jport.port_fastkan(sd, 2)}
        jm = JFastKAN(sizes, grid_min=-1.5, grid_max=2.5, num_grids=6)
    torch.save(sd, on_cpu / "ref.pt")
    built = port_checkpoint.main(["--torch_file", str(on_cpu / "ref.pt"), "--family", family,
                                  "--layers", "2", "--out", str(on_cpu / "ckpt.pt")])
    fresh = port_checkpoint.main(["--torch_file", str(on_cpu / "ref.pt"), "--family", family,
                                  "--layers", "2", "--out", str(on_cpu / "other.pt")])
    for p in fresh.parameters():
        torch.nn.init.zeros_(p)
    checkpoint.restore(str(on_cpu / "ckpt.pt"), fresh)
    for (k, a), (_, b) in zip(built.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), k
    if case == "no_scaler":
        assert not any("spline_scaler" in k for k in fresh.state_dict())
    xt = torch.from_numpy(x)
    for layer in fresh.layers:
        xt = layer(xt)
    want = jnp.asarray(x)
    if jm is None:
        for m, (p, b) in layers:
            want = m.apply({"params": p, "buffers": b}, want)
    else:
        want = jm.apply(variables, want)
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(want), **VAL)


def test_train_node_synthetic_learns(on_cpu, capsys):
    res = train_node_synthetic.main(["--epochs", "30"])
    assert np.mean(res["losses"][-5:]) < np.mean(res["losses"][:5])
    assert 0.0 <= res["test_acc"] <= 1.0 and "test acc:" in capsys.readouterr().out


SCRIPTS = {
    "run_experiments_kan": "node_classification",
    "run_experiments_fastkan": "node_classification",
    "run_experiments_mlp": "node_classification",
    "graph_classification_all": "graph_classification",
    "graph_regression_all": "graph_regression",
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_sweeps_dry_run_equals_the_scripts(name, capsys):
    """Each sweep's commands, extra arguments appended, are the script's:
    bash runs scripts/<name>.sh with `python` a function that echoes its
    arguments, and the port's dry run prints the same driver arguments in
    the same order."""
    out = subprocess.run(
        ["bash", "-c", 'python() { echo "$@"; }; export -f python; bash "$0" "$@"',
         str(REPO / "scripts" / f"{name}.sh"), "--n_trials", "2"],
        capture_output=True, text=True, check=True).stdout.splitlines()
    script = f"experiments/{SCRIPTS[name]}.py "
    want = [line.replace(script, "") for line in out]
    assert all(line.startswith(script) for line in out) and len(want) > 0
    got = sweeps.main([name, "--dry_run", "--n_trials", "2"])
    prefix = f"python -m kagnn_tpu_torch.experiments.{SCRIPTS[name]} "
    assert [line.replace(prefix, "") for line in got] == want
    assert capsys.readouterr().out.splitlines() == got
