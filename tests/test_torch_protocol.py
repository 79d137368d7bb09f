"""The port's protocol layer against the JAX package's on the CPU: the TPE
study (trial parameters exactly, past its random start-up trials), a
checkpoint resume (bit for bit), `train_node_total` with the JAX split's
initial weights (grid adaptation included), `run_node_experiment`'s summary
and log line, `graph_classification_protocol`'s log text and result, and
each of the three drivers' `main()` under KAGNN_PLATFORM=cpu.

Tolerance of `train_node_total`: the best validation loss at the f32 value
bar (rtol 1e-4) and the best state at the f32 gradient bar (rtol 1e-3 /
atol 1e-5): six Adam steps and a grid adaptation on the same f32
arithmetic in another summation order; the epochs run and the
accuracies exactly."""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.train import experiments as jexp
from kagnn_tpu.train import hpo as jhpo
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.train import checkpoint, experiments as texp, hpo as thpo
from kagnn_tpu_torch.train import make_node_steps
from kagnn_tpu_torch.utils.port import from_jax_variables, to_jax_variables

torch.set_num_threads(1)
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


def _space(trial):
    return (trial.suggest_float("lr", 1e-5, 1e-2, log=True),
            trial.suggest_float("dropout", 0.0, 0.9),
            trial.suggest_int("hidden", 2, 128),
            trial.suggest_categorical("act", ["relu", "silu", "gelu"]))


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_tpe_trials_match_jax(direction):
    """20 trials, 8 random start-up trials then 12 TPE proposals: every
    trial's parameters and value equal to the JAX study's, exactly."""
    def objective(trial):
        lr, dropout, hidden, act = _space(trial)
        return ((np.log10(lr) + 3) ** 2 + (dropout - 0.3) ** 2
                + ((hidden - 40) / 50) ** 2 + 0.1 * ["relu", "silu", "gelu"].index(act))

    studies = []
    for mod in (jhpo, thpo):
        study = mod.create_study(direction=direction,
                                 sampler=mod.TPESampler(seed=3))
        study.optimize(objective, n_trials=20)
        studies.append(study)
    want, got = studies
    assert [(t.number, t.params, t.value) for t in got.trials] == \
        [(t.number, t.params, t.value) for t in want.trials]
    assert got.best_params == want.best_params
    r_want = jhpo.create_study(sampler=jhpo.RandomSampler(seed=5))
    r_got = thpo.create_study(sampler=thpo.RandomSampler(seed=5))
    for s in (r_want, r_got):
        s.optimize(lambda t: _space(t)[0], n_trials=5)
    assert [t.params for t in r_got.trials] == [t.params for t in r_want.trials]


def _graph(n=120, seed=3):
    d = community_node_graph(n_nodes=n, n_classes=3, num_features=8, seed=seed)
    return d, single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                           y=d["y"], device="cpu")


KW = dict(conv_type="gin", architecture="kan", mp_layers=2, num_features=8,
          hidden_channels=8, num_classes=3, skip=False, fused=True)


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    """6 steps uninterrupted against 3 steps, a save, a restore into a
    fresh model (other weights) and a fresh Adam, and 3 more: the losses
    and the final state equal bit for bit. BestValKeeper keeps a copy."""
    d, g = _graph()
    mask = g.node_mask

    def fresh(seed):
        m = NodeClassifier(device="cpu", seed=seed, **KW)
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)

    model, opt = fresh(0)
    step, _ = make_node_steps(model, opt)
    whole = [step(g, mask) for _ in range(6)]

    model, opt = fresh(0)
    step, _ = make_node_steps(model, opt)
    part = [step(g, mask) for _ in range(3)]
    keeper = checkpoint.BestValKeeper(save_dir=str(tmp_path), name="best")
    assert keeper.update(0.5, model) and not keeper.update(0.7, model)
    checkpoint.save(str(tmp_path / "ckpt" / "state.pt"), model, opt, step=3)
    model, opt = fresh(1)
    assert checkpoint.restore(str(tmp_path / "ckpt" / "state.pt"), model, opt) == 3
    step, _ = make_node_steps(model, opt)
    part += [step(g, mask) for _ in range(3)]
    assert torch.equal(torch.stack(whole), torch.stack(part))
    kept = keeper.best_state["convs.0.update.layers.0.spline_weight"]
    assert not torch.equal(kept, model.convs[0].update.layers[0].spline_weight)
    restored, _ = fresh(2)
    checkpoint.restore(str(tmp_path / "best"), restored)
    assert all(torch.equal(v, keeper.best_state[k])
               for k, v in restored.state_dict().items())


def test_train_node_total_matches_jax():
    """A split with the JAX split's initial weights carried across, dropout
    0 and update_grid=2 (grids adapted before epochs 2 and 4)."""
    d, g = _graph(n=150, seed=6)
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"])
    n_pad = g.n_node_pad
    masks = [np.zeros(n_pad, bool) for _ in range(3)]
    for m, k in zip(masks, ("train", "val", "test")):
        m[:d["n_node"]] = d["masks"][k]
    cfg = dict(lr=1e-2, epochs=6, patience=100, update_grid=2)
    jm = JaxNodeClassifier(**dict(KW, fused=False))
    key = jax.random.key(11)
    with jsegment.use_pallas_spmm(False):
        v = jm.init({"params": key}, gj)
        want = jexp.train_node_total(jm, gj, cfg, *[jnp.asarray(m) for m in masks],
                                     key)
    model = NodeClassifier(device="cpu", **KW)
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v)))
    got = texp.train_node_total(model, g, cfg, *[torch.from_numpy(m) for m in masks])
    assert got["epochs_run"] == want["epochs_run"] == 6
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], **VAL)
    for k in ("train_acc", "val_acc", "test_acc"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    best = to_jax_variables(got["state"])
    theirs = want["state"].variables()
    for path, leaf in jax.tree_util.tree_leaves_with_path(theirs):
        mine = best
        for p in path:
            mine = mine[p.key]
        np.testing.assert_allclose(mine, np.asarray(leaf), err_msg=str(path), **GRAD)
    # the grids moved off the uniform ones
    assert not np.allclose(best["buffers"]["head"]["grid"],
                           np.asarray(v["buffers"]["head"]["grid"]))


def test_train_node_sampled_matches_jax():
    """A split on sampled mini-batches (fanouts 4 and 3, 32 seeds, sampler
    seed 2; the JAX split's initial weights carried across): the same
    batches in the same order (the runner draws its set-aside first batch as
    the JAX one draws its init batch), so the best validation loss at the
    f32 bar, the epochs and accuracies exactly."""
    d, g = _graph(n=150, seed=6)
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"])
    masks = [np.zeros(g.n_node_pad, bool) for _ in range(3)]
    for m, k in zip(masks, ("train", "val", "test")):
        m[:d["n_node"]] = d["masks"][k]
    cfg = dict(lr=1e-2, epochs=3, patience=100, seed=2)
    sample = dict(fanouts=[4, 3], batch_size=32)
    jm = JaxNodeClassifier(**dict(KW, fused=False))
    key = jax.random.key(12)
    with jsegment.use_pallas_spmm(False):
        v = jm.init({"params": key}, gj)
        want = jexp.train_node_sampled(jm, d, gj, cfg, *[jnp.asarray(m) for m in masks],
                                       key, **sample)
    model = NodeClassifier(device="cpu", **KW)
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v)))
    got = texp.train_node_sampled(model, d, g, cfg, *[torch.from_numpy(m) for m in masks],
                                  **sample)
    assert got["epochs_run"] == want["epochs_run"] == 3
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], **VAL)
    for k in ("train_acc", "val_acc", "test_acc"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_run_node_experiment_summary_and_log_match_jax(tmp_path):
    """The summary's keys and the log line's params equal the JAX runner's
    on the same synthetic stand-in (the same process: the same stand-in
    graph); the port's reorder and sampling paths run through it too."""
    params = {"conv_type": "gcn", "architecture": "fastkan",
              "hidden_channels": 8, "grid_size": 4, "lr": 5e-3, "dropout": 0.0,
              "epochs": 2, "patience": 10, "skip": True, "heads": 1,
              "hidden_layers": 2, "spline_order": 3, "fused": True, "bf16": False}
    lines = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, run, kw in (("jax", jexp.run_node_experiment, {}),
                              ("port", texp.run_node_experiment, {"device": "cpu"})):
            logs = tmp_path / name
            res = run(dict(params, fused=name == "port"), "Cora",
                      data_root=str(tmp_path), log_dir=str(logs), max_splits=2,
                      seed=0, **kw)
            (f,) = logs.iterdir()
            assert f.name == "Cora_fastkan_gcn"
            lines[name] = (res, json.loads(f.read_text()))
        (jres, jline), (tres, tline) = lines["jax"], lines["port"]
        assert tres.keys() == jres.keys() and tline.keys() == jline.keys()
        jline["params"]["fused"] = True
        assert tline["params"] == jline["params"]
        assert tline == json.loads(json.dumps(tres)) and len(tres["test_accs"]) == 2
        for extra in ({"reorder": "rcm"}, {"sampling": [4, 2], "sampling_batch": 64}):
            res = texp.run_node_experiment(dict(params, **extra), "Cora",
                                           data_root=str(tmp_path), log_dir=None,
                                           max_splits=1, device="cpu")
            assert 0.0 <= res["test_acc_mean"] <= 1.0


def test_graph_protocol_log_matches_jax(tmp_path):
    """Stub trainer and objective: the log text and the result identical."""
    out = {}
    for name, mod in (("jax", jexp), ("port", texp)):
        calls = []

        def trainer(params, fold):
            calls.append(fold)
            return 0.8 + 0.01 * params["x"] + 0.001 * len(calls), 1234 + fold

        def objective(trial, fold):
            x = trial.suggest_float("x", 0, 1)
            return (x - 0.6) ** 2 + fold

        log = tmp_path / name / "log"
        res = mod.graph_classification_protocol(
            "FAKE", trainer, objective, str(log), n_outer_folds=3, n_trials=10,
            n_retrains=3, seed=4)
        out[name] = (res, log.read_text())
    assert out["port"] == out["jax"]
    assert out["port"][1].count("SPLIT") == 3


@pytest.mark.parametrize("driver,argv,log", [
    ("node_classification",
     ["--architecture", "kan", "--conv_type", "gin", "--n_trials", "1",
      "--epochs", "2", "--max_splits", "1"], "logs/Cora_kan_gin_finished"),
    ("graph_classification",
     ["--model_type", "GAT", "--architecture", "kan", "--n_trials", "1",
      "--epochs", "1", "--n_outer_folds", "2", "--prefetch", "0"],
     "logs/KAN_MUTAG_GAT"),
    ("graph_regression",
     ["--gnn-type", "GIN", "--model-type", "FASTKAN", "--n_trials", "1",
      "--epochs", "1", "--n_iterations", "1", "--loader", "python"],
     "logs/ZINC_GIN_FASTKAN"),
])
def test_driver_main_on_the_cpu(driver, argv, log, tmp_path, monkeypatch):
    """Each driver's main() end to end on its synthetic stand-in under
    KAGNN_PLATFORM=cpu, writing its log in the JAX driver's format."""
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KAGNN_PLATFORM", "cpu")
    main = importlib.import_module(f"kagnn_tpu_torch.experiments.{driver}").main
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = main(argv + ["--data_root", str(tmp_path / "data")])
    text = (tmp_path / log).read_text()
    if driver == "node_classification":
        line = json.loads(text)
        assert line.keys() == {"mean", "std", "best_params"} and line == res
        assert (tmp_path / "logs" / "Cora_kan_gin").exists()
    elif driver == "graph_classification":
        assert text.startswith("SPLIT 0\nAccuracies [") and "SPLIT 1\n" in text
        assert text.endswith(f"FINAL Mean: {res['mean']}, Std: {res['std']}\n")
    else:
        first, last = text.splitlines()
        assert first.startswith("iter 0 best {'lr': ") and " test_mae " in first
        assert last == f"FINAL {res}"
    monkeypatch.setenv("KAGNN_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        main(argv)
