"""Training steps, the counterparts of `kagnn_tpu/train/loops.py`
`make_node_steps`, `make_node_multi_step`, `make_graph_cls_steps`,
`make_graph_reg_steps`, `train_graph_epochs` and `EarlyStopper`.

The JAX steps thread a TrainState through a jitted function; here the
model and the optimizer hold the state and are updated in place. With
`torch.optim.Adam(params, lr=1e-3)` (betas 0.9/0.999, eps 1e-8) the update
is that of `optax.adam(1e-3)`.

While a profiler runs, each train step records the spans of
`utils/profiling.py`: STEP around it, STEP_FORWARD (the model and the loss)
and STEP_BACKWARD inside it; each call of `make_node_multi_step`'s entry
records MULTI_STEP and, on the card, its capture, copy-in and replay parts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from kagnn_tpu_torch.train import losses
from kagnn_tpu_torch.utils.profiling import (MULTI_STEP, MULTI_STEP_CAPTURE,
                                             MULTI_STEP_COPY_IN, MULTI_STEP_REPLAY,
                                             STEP, STEP_BACKWARD, STEP_FORWARD, span)


class EarlyStopper:
    """Reference node_classification_clean/utils.py:68-86: returns
    (should_save, should_stop)."""

    def __init__(self, patience: int = 1, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.min_validation_loss = float("inf")

    def early_stop(self, validation_loss: float) -> tuple[bool, bool]:
        should_save = False
        if validation_loss < self.min_validation_loss:
            self.min_validation_loss = validation_loss
            self.counter = 0
            should_save = True
        elif validation_loss >= self.min_validation_loss + self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                return False, True
        return should_save, False


def make_node_steps(model, optimizer):
    """Full-batch node classification: masked CE on a per-call mask.
    Returns (train_step(batch, mask) -> loss, evaluate(batch) -> logits)."""

    def train_step(batch, mask):
        with span(STEP):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with span(STEP_FORWARD):
                loss = losses.masked_softmax_cross_entropy(model(batch), batch.y, mask)
            with span(STEP_BACKWARD):
                loss.backward()
            optimizer.step()
            return loss.detach()

    def evaluate(batch):
        """Logits of one forward in eval mode (running BN statistics)."""
        model.eval()
        with torch.no_grad():
            return model(batch)

    return train_step, evaluate


def _graph_steps(model, optimizer, loss_of_output: Callable):
    """A train step on one padded batch: forward in train mode, the loss,
    backward, optimizer.step; returns the loss (not synchronised)."""

    def train_step(batch):
        with span(STEP):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with span(STEP_FORWARD):
                loss = loss_of_output(model(batch), batch)
            with span(STEP_BACKWARD):
                loss.backward()
            optimizer.step()
            return loss.detach()

    return train_step


def make_graph_cls_steps(model, optimizer):
    """Graph classification: masked NLL over `graph_mask`. Returns
    (train_step(batch) -> loss, evaluate(batch) -> (nll sum, correct,
    count)), the JAX evaluate's sums, as 0-d tensors."""
    train_step = _graph_steps(model, optimizer, lambda out, b: losses.masked_nll(
        out, b.y, b.graph_mask))

    def evaluate(batch):
        model.eval()
        with torch.no_grad():
            out = model(batch)
            gm = batch.graph_mask
            count = gm.sum()
            nll_sum = losses.masked_nll(out, batch.y, gm) * count.clamp_min(1)
            correct = ((out.argmax(1) == batch.y.long()) & gm).sum()
        return nll_sum, correct, count

    return train_step, evaluate


def make_graph_reg_steps(model, optimizer):
    """Graph regression: masked L1 over `graph_mask`. Returns
    (train_step(batch) -> loss, evaluate(batch) -> (L1 sum, count))."""
    train_step = _graph_steps(model, optimizer, lambda out, b: losses.masked_l1(
        out, b.y, b.graph_mask))

    def evaluate(batch):
        model.eval()
        with torch.no_grad():
            out = model(batch)
            gm = batch.graph_mask
            count = gm.sum()
            l1_sum = losses.masked_l1(out, batch.y, gm) * count.clamp_min(1)
        return l1_sum, count

    return train_step, evaluate


def train_graph_epochs(model, train_step, evaluate,
                       train_batches: Callable[[], Iterable],
                       val_batches: Callable[[], Iterable], epochs: int,
                       patience: int,
                       test_batches: Optional[Callable[[], Iterable]] = None,
                       classification: bool = True) -> dict:
    """The early-stopped epoch loop of the reference's graph protocol: the
    best validation loss is tracked, the test metric (accuracy, or mean L1)
    recorded at the best-validation epoch. Returns {"state": a copy of the
    model's state_dict at that epoch, "best_val_loss", "test_metric",
    "epochs_run"}. Dropout draws from the model's own generator."""
    stopper = EarlyStopper(patience=patience)
    best_val = float("inf")
    best_test_metric = None
    best_state = _state_copy(model)

    def sums(batches):
        tot, n, correct = 0.0, 0.0, 0.0
        for batch in batches():
            if classification:
                s, c, m = evaluate(batch)
                correct += float(c)
            else:
                s, m = evaluate(batch)
            tot += float(s)
            n += float(m)
        return tot, n, correct

    for epoch in range(epochs):
        for batch in train_batches():
            train_step(batch)
        tot, n, _ = sums(val_batches)
        val_loss = tot / max(n, 1.0)
        if val_loss < best_val:
            best_val = val_loss
            best_state = _state_copy(model)
            if test_batches is not None:
                tt, tn, tc = sums(test_batches)
                best_test_metric = (tc if classification else tt) / max(tn, 1.0)
        _, stop = stopper.early_stop(val_loss)
        if stop:
            break
    return {"state": best_state, "best_val_loss": best_val,
            "test_metric": best_test_metric, "epochs_run": epoch + 1}


def _state_copy(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# eager steps on a side stream before a capture: they build and bind the
# kernels, plan their launches and create the optimizer's state, none of
# which may happen inside a capture; their effect on the weights, the
# BatchNorm statistics, the optimizer's state and the dropout generator is
# undone before it
WARMUP_STEPS = 1


def capture_signature(batch, mask) -> tuple:
    """What a captured step bakes in: every tensor field's name, shape and
    dtype, the mask's, and the three host counts that the kernels take as
    launch arguments (the GAT kernels clip each row at n_edge, for one). A
    call whose signature differs gets a capture of its own, as `jax.jit`
    traces anew for a new shape."""
    fields = tuple((f.name, tuple(v.shape), v.dtype)
                   for f in dataclasses.fields(batch)
                   if isinstance(v := getattr(batch, f.name), torch.Tensor))
    return fields + ((tuple(mask.shape), mask.dtype),
                     (batch.n_node, batch.n_edge, batch.n_graph))


def make_node_multi_step(model, optimizer, n_steps: int):
    """`n_steps` full-batch train steps in one dispatch, the counterpart of
    the JAX `make_node_multi_step` (`lax.scan` over the step). Returns
    `multi(batch, mask) -> losses (n_steps,) f32`.

    On the card the n steps are captured into one `torch.cuda.CUDAGraph`
    per `capture_signature` (after WARMUP_STEPS eager steps on a side
    stream, as PyTorch's whole-network recipe does, whose effect is
    undone): the first call of a signature captures, on the batch's and
    mask's copies that the capture keeps; every later call copies its
    batch's tensor fields and mask into them and replays. A model with
    dropout draws its masks from `model.dropout_generator`, which the graph
    registers, so each replay draws the next masks as eager steps from the
    same state would. On the CPU each call is a loop over `make_node_steps`'
    train_step, drawing from the same generator. On the card the optimizer
    must keep its state there (`require_capturable`), or this raises.
    Nothing falls back to eager steps."""
    train_step, _ = make_node_steps(model, optimizer)
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    if on_card:
        require_capturable(optimizer)
    captures = {}

    def generators():
        if getattr(model, "dropout", 0.0) > 0.0:
            return [model.dropout_generator(device)]
        return []

    def capture(batch, mask):
        gens = generators()
        static = (batch.map_tensors(torch.clone), mask.clone())
        snapshot = _state_snapshot(model, optimizer, gens)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                train_step(*static)
        torch.cuda.current_stream(device).wait_stream(side)
        _state_restore(model, optimizer, gens, snapshot)
        graph = torch.cuda.CUDAGraph()
        for gen in gens:
            graph.register_generator_state(gen)
        optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            losses = torch.stack([train_step(*static) for _ in range(n_steps)])
        return graph, losses, static

    def multi(batch, mask):
        with span(MULTI_STEP):
            if not on_card:
                return torch.stack([train_step(batch, mask) for _ in range(n_steps)])
            key = capture_signature(batch, mask)
            if key not in captures:
                with span(MULTI_STEP_CAPTURE):
                    captures[key] = capture(batch, mask)
            else:
                _, _, (sb, sm) = captures[key]
                with span(MULTI_STEP_COPY_IN), torch.no_grad():
                    for dst, src in zip(sb.tensors(), batch.tensors()):
                        dst.copy_(src)
                    sm.copy_(mask)
            graph, losses, _ = captures[key]
            with span(MULTI_STEP_REPLAY):
                graph.replay()
            return losses.clone()

    multi.captures = captures
    return multi


def require_capturable(optimizer) -> None:
    """Raise unless every parameter group keeps its optimizer state on the
    card (`capturable=True`, as torch.optim.Adam takes it): a captured
    step must not read a step count from the host."""
    if not all(group.get("capturable") for group in optimizer.param_groups):
        raise ValueError("make_node_multi_step captures the steps into a CUDA "
                         "graph and needs an optimizer that keeps its state "
                         "on the card: torch.optim.Adam(..., capturable=True)")


def _state_snapshot(model, optimizer, gens=()):
    """Copies of the model's parameters and buffers, of the optimizer's
    state tensors (per parameter; the keys it holds now) and of the
    generators' states."""
    with torch.no_grad():
        return ({k: v.clone() for k, v in model.state_dict().items()},
                {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                 for p, st in optimizer.state.items()},
                [g.get_state() for g in gens])


def _state_restore(model, optimizer, gens, snapshot):
    """Undo the warm-up in place (the capture reads these very tensors):
    the model's tensors and the generators' states from the snapshot, the
    optimizer's state from it or, where the warm-up created it, zeros
    (Adam's fresh state: step 0 and zero moments)."""
    weights, opt, states = snapshot
    for g, st in zip(gens, states):
        g.set_state(st)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(weights[k])
        for p, st in optimizer.state.items():
            for k, v in st.items():
                if not torch.is_tensor(v):
                    continue
                if p in opt:
                    v.copy_(opt[p][k])
                else:
                    v.zero_()
