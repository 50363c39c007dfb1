"""Hyperparameter optimization (counterpart of ``deepgrp_tpu/hpo``).

The reference drives hyperopt's TPE with pickled ``Trials`` resume (its
``optimization.py``).  This package provides:

  * :mod:`space`: hyperopt-style search-space primitives (uniform,
    quniform, normal, qnormal, lognormal, choice),
  * :mod:`tpe`: a self-contained Tree-structured Parzen Estimator with the
    same ``Trials``-pickle resume (Bergstra et al. 2011),
  * :mod:`optimization`: the train-evaluate objective and the serial sweep
    (``run_a_trial``), with the reference's result dicts,
  * :mod:`vmapped`: parallel trials, a fleet of same-architecture trials
    trained in lockstep through the training kernels,
  * :mod:`bucketed`: the whole reference space (with the qnormal vecsize
    and units dimensions) swept in parallel: TPE proposes batches, trials
    group by shape bucket, each bucket trains as one fleet.

Training and evaluation run on ``device`` (default ``cuda``).
"""

from deepgrp_tpu_torch.hpo.space import (choice, lognormal, normal, qnormal,
                                         quniform, uniform)
from deepgrp_tpu_torch.hpo.tpe import STATUS_FAIL, STATUS_OK, Trials, fmin
from deepgrp_tpu_torch.hpo.optimization import (build_and_optimize,
                                                run_a_trial)
from deepgrp_tpu_torch.hpo.bucketed import run_bucketed_sweep

__all__ = [
    "uniform", "quniform", "normal", "qnormal", "lognormal", "choice",
    "Trials", "fmin", "STATUS_OK", "STATUS_FAIL",
    "build_and_optimize", "run_a_trial", "run_bucketed_sweep",
]
