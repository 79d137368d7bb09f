"""Experiment runners, the counterparts of `kagnn_tpu/train/experiments.py`:
the reference's protocol layer on the port's models and steps.

Node classification: `run_node_experiment` == reference `run_experiment` +
`all_splits` + `train_total` (node_classification_clean/utils.py:162-236):
every split, Adam, best-val-loss state restore, early stopping, mean/std
test accuracy, an append-style JSON log line with the JAX keys.

Graph classification: `graph_classification_protocol` == reference
`parameters_finder` (graph_classification_utils.py:93-159): per outer fold,
HPO on that fold's train/val, then retrains reporting test accuracy, the
JAX log text line for line. `batch_loader` feeds the graph tasks.

The port's models hold their weights: `train_node_total` trains the model
it is given, and `run_node_experiment` builds each split's model afresh,
its parameters drawn from a per-split seed derived from `seed` (without
that, split 2 would start from split 1's trained weights).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from kagnn_tpu_torch.data import DATASET_LAYERS, load_node_dataset
from kagnn_tpu_torch.graphs.batch import batch_graphs, single_graph
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.train import losses
from kagnn_tpu_torch.train.loops import (EarlyStopper, _state_copy,
                                        make_node_steps)
from kagnn_tpu_torch.utils.device import resolve_device


def _pad_mask(m: np.ndarray, n_pad: int, device) -> torch.Tensor:
    return torch.from_numpy(
        np.concatenate([m, np.zeros(n_pad - m.shape[0], bool)])).to(device)


def _final_metrics(model, evaluate, g, best_val, best_state, train_mask,
                   val_mask, test_mask, epoch) -> dict:
    """Load the best state back and evaluate it (the reference's stale-`out`
    post-reload evaluation is not copied, as in the JAX runner)."""
    model.load_state_dict(best_state)
    logits = evaluate(g)
    return {
        "train_acc": float(losses.masked_accuracy(logits, g.y, train_mask)),
        "val_acc": float(losses.masked_accuracy(logits, g.y, val_mask)),
        "val_loss": best_val,
        "test_acc": float(losses.masked_accuracy(logits, g.y, test_mask)),
        "epochs_run": epoch + 1,
        "state": best_state,
    }


def train_node_total(model, g, params_cfg: dict, train_mask, val_mask,
                     test_mask) -> dict:
    """One split's full-batch training of `model` on g (reference
    utils.py:162-193): Adam(lr), an epoch a step, the validation loss after
    each, early stopping on it, the best-validation state kept (a cloned
    state_dict on the device) and loaded back at the end. With
    `update_grid` = N, every KANLinear's grid is adapted to the live
    activations every N epochs (`kan/adapt.py`, before the epoch's step;
    the reference's KAN.forward(update_grid=True)). Masks are bool tensors
    over g's padded rows. Returns the JAX runner's dict, "state" the best
    state_dict."""
    opt = torch.optim.Adam(model.parameters(), lr=params_cfg["lr"])
    train_step, evaluate = make_node_steps(model, opt)
    stopper = EarlyStopper(patience=params_cfg.get("patience", 100))
    best_val = float("inf")
    best_state = _state_copy(model)
    update_grid = int(params_cfg.get("update_grid", 0) or 0)
    for epoch in range(params_cfg.get("epochs", 1000)):
        if update_grid and epoch > 0 and epoch % update_grid == 0:
            from kagnn_tpu_torch.kan.adapt import adapt_model_grids

            adapt_model_grids(model, g)
        train_step(g, train_mask)
        logits = evaluate(g)
        val_loss = float(losses.masked_softmax_cross_entropy(
            logits, g.y, val_mask))
        should_save, should_stop = stopper.early_stop(val_loss)
        if should_save and val_loss < best_val:
            best_val = val_loss
            best_state = _state_copy(model)
        if should_stop:
            break
    return _final_metrics(model, evaluate, g, best_val, best_state,
                          train_mask, val_mask, test_mask, epoch)


def train_node_sampled(model, d: dict, g, params_cfg: dict, train_mask,
                       val_mask, test_mask, fanouts,
                       batch_size: int = 512) -> dict:
    """One split trained on GraphSAGE-style sampled mini-batches
    (data/sampling.NeighborSampler, seeded by params_cfg["seed"], default
    0) with full-graph evaluation on g; `train_node_total`'s contract.
    The first batch is drawn and set aside before the epochs, as the JAX
    runner draws it to initialise its state, so that the sampler's
    generator gives both runners the same batches."""
    from kagnn_tpu_torch.data.sampling import NeighborSampler

    opt = torch.optim.Adam(model.parameters(), lr=params_cfg["lr"])
    train_np = train_mask.cpu().numpy()[:int(d["n_node"])]
    sampler = NeighborSampler(d["senders"], d["receivers"], int(d["n_node"]),
                              fanouts=fanouts,
                              batch_size=min(batch_size, int(train_np.sum())),
                              seed=params_cfg.get("seed", 0), device=g.device)
    train_nodes = np.flatnonzero(train_np)
    next(sampler.epoch(train_nodes, d["nodes"], d["y"]))
    train_step, evaluate = make_node_steps(model, opt)
    seed_mask = sampler.seed_mask()
    stopper = EarlyStopper(patience=params_cfg.get("patience", 100))
    best_val, best_state = float("inf"), _state_copy(model)
    for epoch in range(params_cfg.get("epochs", 1000)):
        for b in sampler.epoch(train_nodes, d["nodes"], d["y"]):
            train_step(b, seed_mask)
        logits = evaluate(g)
        val_loss = float(losses.masked_softmax_cross_entropy(
            logits, g.y, val_mask))
        should_save, should_stop = stopper.early_stop(val_loss)
        if should_save and val_loss < best_val:
            best_val, best_state = val_loss, _state_copy(model)
        if should_stop:
            break
    return _final_metrics(model, evaluate, g, best_val, best_state,
                          train_mask, val_mask, test_mask, epoch)


def make_node_model(params: dict, seed: int = 0, device=None) -> NodeClassifier:
    """Reference `make_model` (utils.py:88-123), its weights drawn from
    `seed`, on `device` (CUDA unless told otherwise)."""
    return NodeClassifier(
        conv_type=params["conv_type"],
        architecture=params["architecture"],
        mp_layers=params["mp_layers"],
        num_features=params["num_features"],
        hidden_channels=params["hidden_channels"],
        num_classes=params["num_classes"],
        skip=bool(params.get("skip", True)),
        grid_size=params.get("grid_size", 4) or 4,
        spline_order=params.get("spline_order", 3) or 3,
        hidden_layers=params.get("hidden_layers", 2) or 2,
        dropout=params.get("dropout", 0.0),
        heads=params.get("heads", 4),
        fused=params.get("fused", False),
        compute_dtype=torch.bfloat16 if params.get("bf16") else None,
        seed=seed, device=device,
    )


def run_node_experiment(params: dict, dataset_name: str,
                        data_root: str = "data", log_dir: str = "logs",
                        max_splits: Optional[int] = None,
                        seed: int = 0, device=None) -> dict:
    """Reference `run_experiment` (utils.py:213-236): all splits (at most
    `max_splits`), each on a fresh model whose weights come from a
    per-split seed drawn from `seed`, optionally renumbered (`reorder`:
    "rcm", "bfs" or "degree", graphs/reorder.py) and trained full batch or,
    with `sampling` (per-hop fanouts), on sampled mini-batches; appends the
    summary as a JSON line to `<log_dir>/<dataset>_<architecture>_<conv>`.
    Returns the summary (mean validation loss, test accuracy mean/std)."""
    dev = resolve_device(device)
    d = load_node_dataset(dataset_name, data_root)
    params = dict(params)
    params["mp_layers"] = params.get("mp_layers") or DATASET_LAYERS.get(
        dataset_name, 2)
    params["num_classes"] = d["num_classes"]
    params["num_features"] = d["nodes"].shape[1]

    reorder = params.get("reorder") or "none"
    if reorder != "none":
        # renumber nodes for gather locality (graphs/reorder.py); masks and
        # labels are permuted consistently so the protocol is unchanged
        from kagnn_tpu_torch.graphs.reorder import (bfs_order, degree_order,
                                                    reorder_graph)
        d = reorder_graph(d, {"rcm": bfs_order, "bfs": bfs_order,
                              "degree": degree_order}[reorder])

    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     device=dev)
    sampling = params.get("sampling") or None

    n_splits = d["train_masks"].shape[0]
    if max_splits:
        n_splits = min(n_splits, max_splits)
    results = []
    split_seeds = torch.randint(0, 2 ** 31 - 1, (n_splits,),
                                generator=torch.Generator().manual_seed(seed))
    for i, split_seed in enumerate(split_seeds.tolist()):
        model = make_node_model(params, seed=split_seed, device=dev)
        masks = tuple(_pad_mask(d[k][i], g.n_node_pad, dev)
                      for k in ("train_masks", "val_masks", "test_masks"))
        if sampling:
            res = train_node_sampled(
                model, d, g, params, *masks, fanouts=sampling,
                batch_size=params.get("sampling_batch", 512))
        else:
            res = train_node_total(model, g, params, *masks)
        res.pop("state")
        results.append(res)

    test_accs = np.array([r["test_acc"] for r in results])
    val_losses = np.array([r["val_loss"] for r in results])
    summary = {
        "params": {k: v for k, v in params.items() if k != "state"},
        "val_loss_mean": float(val_losses.mean()),
        "test_acc_mean": float(test_accs.mean()),
        "test_acc_std": float(test_accs.std(ddof=1)) if len(test_accs) > 1 else 0.0,
        "test_accs": test_accs.tolist(),
    }
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log_file = os.path.join(
            log_dir,
            f"{dataset_name}_{params['architecture']}_{params['conv_type']}")
        with open(log_file, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return summary


# ------------------------------------------------------- graph-level tasks

def batch_loader(graphs: list[dict], spec, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 native: Optional[bool] = None, prefetch: int = 0,
                 device=None):
    """Returns a callable yielding padded GraphBatches (static shapes) on
    `device` (CUDA unless told otherwise), one pass over `graphs` per call.

    `native`: assemble through the C++ assembler (data/native.py,
    bit-identical to `batch_graphs`): True requires it and raises when it
    does not build; None uses it when the graphs carry no edge features and
    it builds, and on the CPU falls back to `batch_graphs` when it does
    not (on the card a failed build raises); False uses `batch_graphs`.
    `prefetch`: keep that many batches in flight on a worker thread,
    host->device copies included (train/prefetch.py); 0 assembles and
    copies each batch when it is asked for. Shuffled orders come from
    `np.random.default_rng(seed)`, one permutation per pass, as in the
    JAX loader."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    assembler = None
    has_edge_feat = any(g.get("edges") is not None for g in graphs)
    if native or (native is None and not has_edge_feat):
        from kagnn_tpu_torch.data.native import NativeBatchAssembler, load

        try:
            load()
        except RuntimeError:
            if native or dev.type != "cpu":
                raise
        else:
            assembler = NativeBatchAssembler(graphs, spec)
    host = "cpu" if prefetch > 0 else dev

    def gen():
        order = rng.permutation(len(graphs)) if shuffle else np.arange(
            len(graphs))
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            if assembler is not None:
                b = assembler.assemble(sel, device=host)
            else:
                b = batch_graphs([graphs[j] for j in sel], spec, device=host)
            yield b

    if prefetch > 0:
        from kagnn_tpu_torch.train.prefetch import prefetch_to_device

        def it():
            return prefetch_to_device(gen(), size=prefetch, device=dev)
    else:
        def it():
            return gen()

    return it


def graph_classification_protocol(
    dataset: str,
    trainer: Callable[[dict, int], tuple[float, int]],
    objective: Callable,
    log_file: str,
    n_outer_folds: int = 10,
    n_trials: int = 100,
    n_retrains: int = 3,
    seed: int = 12345,
    split_dir: Optional[str] = None,
) -> dict:
    """The Errica-protocol outer loop == reference `parameters_finder`
    (graph_classification_utils.py:93-159): per outer fold, an HPO study on
    that fold's train/val split, then `n_retrains` retrains with the best
    hyperparameters reporting test accuracy. `trainer(params, fold)` must
    return (test_acc, model_size); `objective(trial, fold)` returns val loss.
    """
    from kagnn_tpu_torch.train.hpo import TPESampler, create_study

    fold_means, all_best, sizes = [], [], []
    for fold in range(n_outer_folds):
        study = create_study(direction="minimize",
                             sampler=TPESampler(seed=seed))
        study.optimize(lambda t: objective(t, fold), n_trials=n_trials)
        best = dict(study.best_params)
        accs = []
        size = 0
        for _ in range(n_retrains):
            acc, size = trainer(best, fold)
            accs.append(acc)
        all_best.append(best)
        sizes.append(size)
        fold_means.append(float(np.mean(accs)))
        if log_file:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            with open(log_file, "a") as f:
                f.write(f"SPLIT {fold}\n")
                f.write(f"Accuracies {fold_means}\n")
                f.write(f"Params {all_best}\n")
                f.write(f"Size {sizes}\n")
                f.write(f"Mean {np.mean(accs)}, Std {np.std(accs)}\n\n")
    result = {
        "dataset": dataset,
        "fold_accs": fold_means,
        "mean": float(np.mean(fold_means)),
        "std": float(np.std(fold_means, ddof=1)) if len(fold_means) > 1 else 0.0,
        "best_hyperparams": all_best,
    }
    if log_file:
        with open(log_file, "a") as f:
            f.write(f"FINAL Mean: {result['mean']}, Std: {result['std']}\n")
    return result
