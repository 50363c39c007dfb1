"""Search-space primitives with hyperopt's semantics.

A copy of ``deepgrp_tpu/hpo/space.py`` (numpy only): with the same
``np.random.Generator`` it draws exactly what that module draws.

The reference's notebook space (its ``DeepGRP.ipynb`` sweep):
``qnormal vecsize(200,20,2), qnormal gru_units(34,5,2),
uniform dropout(0,0.4), uniform momentum(0,1), uniform rho(0,1),
uniform repeat_probability(0,0.49), lognormal learning_rate(-7,0.5)``.

Each dimension can ``sample`` from its prior and knows how to transform
to/from the unconstrained space the TPE models (log for lognormal,
identity otherwise) plus its quantization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np


@dataclass(frozen=True)
class Dimension:
    """One search dimension."""

    name: str
    kind: str                       # uniform|quniform|normal|qnormal|lognormal|choice
    params: tuple = ()
    options: tuple = ()             # for choice
    low: Any = None                 # optional clamp (qnormal/normal): a
    high: Any = None                # <=0 draw would crash the trial

    def _clamp(self, value: float) -> float:
        if self.low is not None:
            value = max(value, self.low)
        if self.high is not None:
            value = min(value, self.high)
        return value

    def sample(self, rng: np.random.Generator) -> Any:
        if self.kind == "uniform":
            low, high = self.params
            return float(rng.uniform(low, high))
        if self.kind == "quniform":
            low, high, q = self.params
            return float(np.round(rng.uniform(low, high) / q) * q)
        if self.kind == "normal":
            mu, sigma = self.params
            return self._clamp(float(rng.normal(mu, sigma)))
        if self.kind == "qnormal":
            mu, sigma, q = self.params
            return self._clamp(float(np.round(rng.normal(mu, sigma) / q)
                                     * q))
        if self.kind == "lognormal":
            mu, sigma = self.params
            return float(np.exp(rng.normal(mu, sigma)))
        if self.kind == "choice":
            return self.options[int(rng.integers(len(self.options)))]
        raise ValueError(self.kind)

    # --- transforms into the (unbounded-ish) space the TPE models ---

    def to_latent(self, value: Any) -> float:
        if self.kind == "lognormal":
            return float(np.log(value))
        if self.kind == "choice":
            return float(self.options.index(value))
        return float(value)

    def from_latent(self, latent: float) -> Any:
        if self.kind == "lognormal":
            return float(np.exp(latent))
        if self.kind == "choice":
            idx = int(np.clip(round(latent), 0, len(self.options) - 1))
            return self.options[idx]
        value = float(latent)
        if self.kind in ("quniform", "qnormal"):
            q = self.params[-1]
            value = float(np.round(value / q) * q)
        if self.kind in ("uniform", "quniform"):
            low, high = self.params[0], self.params[1]
            value = float(np.clip(value, low, high))
        if self.kind in ("normal", "qnormal"):
            value = self._clamp(value)
        return value


def uniform(name: str, low: float, high: float) -> Dimension:
    return Dimension(name, "uniform", (low, high))


def quniform(name: str, low: float, high: float, q: float) -> Dimension:
    return Dimension(name, "quniform", (low, high, q))


def normal(name: str, mu: float, sigma: float) -> Dimension:
    return Dimension(name, "normal", (mu, sigma))


def qnormal(name: str, mu: float, sigma: float, q: float,
            low: Any = None, high: Any = None) -> Dimension:
    return Dimension(name, "qnormal", (mu, sigma, q), low=low, high=high)


def lognormal(name: str, mu: float, sigma: float) -> Dimension:
    return Dimension(name, "lognormal", (mu, sigma))


def choice(name: str, options: Sequence[Any]) -> Dimension:
    return Dimension(name, "choice", (), tuple(options))


def reference_search_space() -> Dict[str, Dimension]:
    """The space used by the reference's DeepGRP.ipynb sweep."""
    return {
        # The reference space is unclamped and a <=0 tail draw crashes
        # the trial into STATUS_FAIL, burning TPE budget; clamping to the
        # minimal valid architecture keeps the prior intact elsewhere.
        "vecsize": qnormal("vecsize", 200, 20, 2, low=2),
        "units": qnormal("units", 34, 5, 2, low=2),
        "dropout": uniform("dropout", 0, 0.4),
        "momentum": uniform("momentum", 0, 1),
        "rho": uniform("rho", 0, 1),
        "repeat_probability": uniform("repeat_probability", 0, 0.49),
        "learning_rate": lognormal("learning_rate", -7, 0.5),
    }


def sample_space(space: Dict[str, Dimension],
                 rng: np.random.Generator) -> Dict[str, Any]:
    return {name: dim.sample(rng) for name, dim in space.items()}
