"""Tree-structured Parzen Estimator sweep with pickle resume.

A copy of ``deepgrp_tpu/hpo/tpe.py`` (numpy only): with the same
``np.random.default_rng`` seed it proposes exactly what that module
proposes.  The API follows the part of hyperopt the reference uses (its
``optimization.py:109-154``): a ``Trials`` container that pickles and
unpickles for resume, ``fmin(objective, space, trials, max_evals)``, and
the ``STATUS_OK`` / ``STATUS_FAIL`` result statuses.

TPE (Bergstra et al., "Algorithms for Hyper-Parameter Optimization",
NeurIPS 2011): after ``n_startup`` random trials, completed trials are
split at the gamma-quantile of loss into good (l) and bad (g) sets; each
dimension is modeled with a 1-D Gaussian kernel density in its latent
space; candidates are drawn from l and ranked by the density ratio
l(x)/g(x); the best candidate is evaluated next.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deepgrp_tpu_torch.hpo.space import Dimension

_LOG = logging.getLogger(__name__)

STATUS_OK = "ok"
STATUS_FAIL = "fail"


class Trials:
    """Completed-trial store, pickle-compatible across runs."""

    def __init__(self) -> None:
        self.trials: List[Dict[str, Any]] = []

    def record(self, params: Dict[str, Any],
               result: Dict[str, Any]) -> None:
        self.trials.append({"params": params, "result": result})

    def losses(self) -> List[float]:
        return [t["result"].get("loss", np.inf) for t in self.trials]

    def best_trial(self) -> Optional[Dict[str, Any]]:
        ok = [t for t in self.trials
              if t["result"].get("status") == STATUS_OK
              and np.isfinite(t["result"].get("loss", np.inf))]
        if not ok:
            return None
        return min(ok, key=lambda t: t["result"]["loss"])

    def __len__(self) -> int:
        return len(self.trials)


def _kde_logpdf(x: np.ndarray, samples: np.ndarray) -> np.ndarray:
    """Gaussian KDE log density of ``x`` under ``samples`` (1-D)."""
    n = samples.size
    spread = samples.std()
    if spread == 0 or not np.isfinite(spread):
        spread = max(abs(samples.mean()), 1.0) * 0.1
    bandwidth = max(spread * n ** (-0.2), 1e-6)  # Scott's rule
    diff = (x[:, None] - samples[None, :]) / bandwidth
    log_kernels = -0.5 * diff**2 - 0.5 * np.log(2 * np.pi) - np.log(bandwidth)
    return np.logaddexp.reduce(log_kernels, axis=1) - np.log(n)


def suggest(space: Dict[str, Dimension], trials: Trials,
            rng: np.random.Generator, n_startup: int = 20,
            gamma: float = 0.25, n_candidates: int = 24) -> Dict[str, Any]:
    """Propose the next trial's parameters."""
    complete = [t for t in trials.trials
                if np.isfinite(t["result"].get("loss", np.inf))]
    if len(complete) < n_startup:
        return {name: dim.sample(rng) for name, dim in space.items()}

    losses = np.array([t["result"]["loss"] for t in complete])
    n_good = max(1, int(np.ceil(gamma * len(complete))))
    order = np.argsort(losses, kind="stable")
    good = [complete[i] for i in order[:n_good]]
    bad = [complete[i] for i in order[n_good:]] or good

    proposal: Dict[str, Any] = {}
    for name, dim in space.items():
        good_lat = np.array([dim.to_latent(t["params"][name]) for t in good])
        bad_lat = np.array([dim.to_latent(t["params"][name]) for t in bad])
        # sample candidates from the good KDE
        n = good_lat.size
        spread = good_lat.std()
        if spread == 0 or not np.isfinite(spread):
            spread = max(abs(good_lat.mean()), 1.0) * 0.1
        bandwidth = max(spread * n ** (-0.2), 1e-6)
        centers = good_lat[rng.integers(n, size=n_candidates)]
        candidates = centers + rng.normal(0, bandwidth, size=n_candidates)
        score = (_kde_logpdf(candidates, good_lat) -
                 _kde_logpdf(candidates, bad_lat))
        proposal[name] = dim.from_latent(float(candidates[np.argmax(score)]))
    return proposal


def fmin(objective: Callable[[Dict[str, Any]], Dict[str, Any]],
         space: Dict[str, Dimension], trials: Trials, max_evals: int,
         seed: Optional[int] = None, n_startup: int = 20) -> Trials:
    """Run TPE until ``trials`` holds ``max_evals`` results."""
    rng = np.random.default_rng(seed)
    while len(trials) < max_evals:
        params = suggest(space, trials, rng, n_startup=n_startup)
        _LOG.info("trial %d: %s", len(trials) + 1, params)
        result = objective(params)
        trials.record(params, result)
    return trials
