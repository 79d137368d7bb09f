"""The comparison that decides `correct`: the program's first steps against
the plain reference's from the same weights and inputs.

The numbers, of which `cells/<cell>.json` names those a cell compares, each
with its limit:
  * `loss_gap`: the largest relative gap between the two sides' loss over
    the steps followed;
  * `grad_gap`: by the worst leaf, the gap between the norms of the two
    sides' gradient of the step read (as the optimizer got it), over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; `grad_gap_median`: the median leaf's gap;
  * `change_gap`: the same for each leaf's change over the steps followed. Leaves whose reference gradient is under a
    thousandth of the median leaf's (a bias under BatchNorm) move under
    Adam by round-off alone and are left out by that rule.
"""
from __future__ import annotations

import math

import torch

NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap")
STILL = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict[str, float]:
    pn = {k: float(torch.linalg.vector_norm(prog[k].float())) for k in leaves}
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in leaves}
    floor = _median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in leaves}


def gaps(prog: dict, ref: dict, initial: dict) -> dict:
    """prog and ref: {"losses": [...], "grads": {name: tensor}, "params":
    {name: tensor}}; initial: the weights both started from. Returns each
    number with the leaf that set it and the leaves left out."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    names = list(ref["grads"])
    rg = {k: float(torch.linalg.vector_norm(ref["grads"][k])) for k in names}
    still = [k for k in names if rg[k] < STILL * _median(rg.values())]
    moving = [k for k in names if k not in still]
    grad = _leaf_gaps(prog["grads"], ref["grads"], names)
    change = _leaf_gaps({k: prog["params"][k].float() - initial[k] for k in moving},
                        {k: ref["params"][k] - initial[k] for k in moving}, moving)
    nan = lambda x: math.inf if math.isnan(x) else x  # noqa: E731
    return {"loss_gap": nan(max(losses)),
            "grad_gap": nan(max(grad.values())), "grad_gap_median": nan(_median(grad.values())),
            "change_gap": nan(max(change.values())),
            "grad_leaf": max(grad, key=grad.get), "change_leaf": max(change, key=change.get),
            "still": still}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the cell compares within its limit (a NaN fails)."""
    return all(numbers[k] <= limit for k, limit in limits.items())
