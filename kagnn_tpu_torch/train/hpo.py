"""Hyperparameter optimization, the counterpart of `kagnn_tpu/train/hpo.py`
(numpy only, verbatim): an optuna-compatible API with a built-in TPE
sampler. The same seed and the same objective values give the same trial
parameters as the JAX study, bit for bit.

The reference drives all experiments through Optuna TPE studies
(one_experiment.py:50-51, graph_classification_utils.py:112-113 — 100 trials,
minimize val loss); this module provides the needed subset natively:

    study = create_study(direction="minimize", sampler=TPESampler(seed=0))
    study.optimize(objective, n_trials=100)
    study.best_params

`objective(trial)` uses trial.suggest_float / suggest_int /
suggest_categorical with the same signatures the reference's search spaces
use. The sampler is a Tree-structured Parzen Estimator: after `n_startup`
random trials, candidates are scored by the ratio of Parzen densities fit to
the best-gamma fraction vs the rest.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class _ParamDef:
    kind: str  # "float" | "int" | "categorical"
    low: float = 0.0
    high: float = 1.0
    log: bool = False
    choices: tuple = ()

    def to_unit(self, v) -> float:
        if self.kind == "categorical":
            return self.choices.index(v) / max(len(self.choices) - 1, 1)
        if self.log:
            return ((math.log(v) - math.log(self.low))
                    / (math.log(self.high) - math.log(self.low)))
        return (v - self.low) / (self.high - self.low)

    def from_unit(self, u: float):
        u = min(max(u, 0.0), 1.0)
        if self.kind == "categorical":
            return self.choices[int(round(u * (len(self.choices) - 1)))]
        if self.log:
            v = math.exp(math.log(self.low)
                         + u * (math.log(self.high) - math.log(self.low)))
        else:
            v = self.low + u * (self.high - self.low)
        if self.kind == "int":
            return int(min(max(round(v), self.low), self.high))
        return float(v)


class Trial:
    def __init__(self, study: "Study", number: int, params: Optional[dict] = None):
        self.study = study
        self.number = number
        self.params: dict[str, Any] = {}
        self._fixed = params or {}

    def _suggest(self, name: str, pd: _ParamDef):
        self.study._register(name, pd)
        if name in self._fixed:
            v = self._fixed[name]
        else:
            v = self.study._sampler.sample(self.study, name, pd)
        self.params[name] = v
        return v

    def suggest_float(self, name, low, high, log=False):
        return self._suggest(name, _ParamDef("float", low, high, log))

    def suggest_int(self, name, low, high):
        return self._suggest(name, _ParamDef("int", low, high))

    def suggest_categorical(self, name, choices):
        return self._suggest(name, _ParamDef("categorical",
                                             choices=tuple(choices)))


class RandomSampler:
    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)

    def sample(self, study, name, pd: _ParamDef):
        return pd.from_unit(float(self.rng.random()))


class TPESampler:
    """Univariate TPE: fit Parzen (Gaussian KDE in unit space) over the best
    gamma-fraction of completed trials ("good") and the rest ("bad"); draw
    candidates from good and keep the argmax of density ratio l(x)/g(x)."""

    def __init__(self, seed: Optional[int] = None, n_startup_trials: int = 8,
                 n_candidates: int = 48, gamma: float = 0.15):
        # defaults validated against random search on seeded quadratics
        # with the reference's search-space shapes (log lr, int width,
        # linear dropout): best-of-50 beats random's best-of-50 in 10/10
        # seeds (tests/test_hpo.py::test_tpe_beats_random_on_quadratic)
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma

    def _kde_logpdf(self, x: np.ndarray, samples: np.ndarray) -> np.ndarray:
        if len(samples) == 0:
            return np.zeros_like(x)
        bw = max(1.0 / (1 + len(samples)) ** 0.5 * 0.5, 0.05)
        d = (x[:, None] - samples[None, :]) / bw
        # log-sum-exp over mixture components
        m = (-0.5 * d * d)
        mx = m.max(axis=1, keepdims=True)
        return (mx[:, 0] + np.log(np.exp(m - mx).sum(axis=1))
                - math.log(len(samples) * bw))

    def sample(self, study: "Study", name: str, pd: _ParamDef):
        done = [(t, v) for t, v in study._history if name in t]
        if len(done) < self.n_startup:
            return pd.from_unit(float(self.rng.random()))
        done.sort(key=lambda tv: tv[1])
        n_good = max(1, int(self.gamma * len(done)))
        good = np.array([pd.to_unit(t[name]) for t, _ in done[:n_good]])
        bad = np.array([pd.to_unit(t[name]) for t, _ in done[n_good:]])
        # candidates drawn from the good KDE + uniform exploration
        bw = max(1.0 / (1 + len(good)) ** 0.5 * 0.5, 0.05)
        centers = self.rng.choice(good, size=self.n_candidates)
        cands = centers + self.rng.normal(0, bw, self.n_candidates)
        cands = np.clip(np.concatenate(
            [cands, self.rng.random(self.n_candidates // 3 + 1)]), 0, 1)
        score = self._kde_logpdf(cands, good) - self._kde_logpdf(cands, bad)
        return pd.from_unit(float(cands[int(np.argmax(score))]))


@dataclasses.dataclass
class FrozenTrial:
    number: int
    params: dict
    value: float


class Study:
    def __init__(self, direction: str = "minimize",
                 sampler: Optional[Any] = None):
        assert direction in ("minimize", "maximize")
        self.direction = direction
        self._sampler = sampler or TPESampler()
        self._space: dict[str, _ParamDef] = {}
        self.trials: list[FrozenTrial] = []

    # history in *minimize* convention
    @property
    def _history(self):
        sign = 1.0 if self.direction == "minimize" else -1.0
        return [(t.params, sign * t.value) for t in self.trials]

    def _register(self, name: str, pd: _ParamDef):
        self._space[name] = pd

    def optimize(self, objective: Callable[[Trial], float], n_trials: int,
                 callbacks: Sequence[Callable] = (), **_ignored):
        for _ in range(n_trials):
            trial = Trial(self, len(self.trials))
            value = float(objective(trial))
            ft = FrozenTrial(trial.number, dict(trial.params), value)
            self.trials.append(ft)
            for cb in callbacks:
                cb(self, ft)

    @property
    def best_trial(self) -> FrozenTrial:
        sign = 1.0 if self.direction == "minimize" else -1.0
        return min(self.trials, key=lambda t: sign * t.value)

    @property
    def best_params(self) -> dict:
        return self.best_trial.params

    @property
    def best_value(self) -> float:
        return self.best_trial.value


def create_study(direction: str = "minimize", sampler=None) -> Study:
    return Study(direction=direction, sampler=sampler)
