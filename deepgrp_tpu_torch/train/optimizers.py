"""Optimizer construction with the reference's TF parameter mapping.

Counterpart of ``deepgrp_tpu/train/optimizers.py`` (parity with
the reference DeepGRP's ``model.py:202-215``):

* ``RMSprop``: ``rho`` is the decay of the squared-gradient average and
  ``momentum`` a trace of the updates, with epsilon *inside* the square
  root, as in TF2 and ``optax.rmsprop``::

      nu = rho nu + (1 - rho) g^2
      u = -lr g / sqrt(nu + eps)
      m = u + momentum m   (only when momentum is truthy; then u = m)
      p = p + u

  ``torch.optim.RMSprop`` puts epsilon outside the root (``sqrt(v) +
  eps``), which differs wherever ``nu`` is tiny (with the default
  ``epsilon = 1e-10``, e.g. an input row that no batch selects), so
  :class:`RMSprop` here follows the composition above.
* ``Adam``: ``momentum -> beta_1``, ``rho -> beta_2`` (epsilon outside the
  root in TF2, optax and torch alike): ``torch.optim.Adam``.

Any other name is, as in the JAX package (``optimizers.py:35-38``),
``getattr(optax, name.lower())(learning_rate=lr)`` with optax's defaults,
and maps to the ``torch.optim`` class (or, for ``rmsprop`` and
``adagrad``, the classes below) that computes the same update, optax's
defaults passed explicitly (:data:`OPTAX_DEFAULTS`; they differ from
torch's, e.g. ``adamw``'s weight decay is 1e-4 and ``adagrad``'s
accumulator starts at 0.1 with ``eps`` 1e-7 inside the root).  A name
whose ``torch.optim`` update differs from optax's raises ``ValueError``:
``amsgrad`` (optax keeps the maximum of the bias-corrected second moment,
torch the maximum of the raw one), ``nadam`` and ``nadamw`` (torch's
``NAdam`` decays the momentum on a schedule), ``radam`` (torch adds
``eps`` before the bias correction), and every optax optimizer
``torch.optim`` lacks (``lamb``, ``lion``, ``lars``, ``novograd``,
``yogi``, ...).

:func:`fleet_optimizer` is the HPO fleet's optimizer: one param group a
trial, each with its own hyperparameters (the JAX fleet's
``_injected_optimizer`` / ``_set_hyperparams``, ``hpo/vmapped.py:35-54``).

Every optimizer built here for CUDA parameters can be captured in a CUDA
graph (:mod:`deepgrp_tpu_torch.train.step_graph`): :class:`RMSprop` and
:class:`Adagrad` hold their state in tensors created at the first step,
``SGD`` (no momentum) has none, and the ``torch.optim`` classes that
count their steps on the host (:data:`CAPTURABLE`) are built with
``capturable=True``.  Their bias corrections then run on the device and
may differ from the host's in the last ulp, so a captured run's bit-for-bit
reference is the same optimizer, built the same way, run eagerly.  On the
CPU they are built as ``torch.optim``'s defaults build them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from deepgrp_tpu_torch.config import Options


class _ElementwiseOptimizer(torch.optim.Optimizer):
    """An elementwise update, one parameter at a time, whose state is held
    in tensors (no host count); a parameter without a gradient takes no
    step."""

    @torch.no_grad()
    def step(self, closure=None):  # pylint: disable=arguments-differ
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for param in group["params"]:
                if param.grad is not None:
                    param.add_(self._update(group, self.state[param], param,
                                            param.grad))
        return loss

    def _update(self, group: dict, state: dict, param: torch.Tensor,
                grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class RMSprop(_ElementwiseOptimizer):
    """RMSprop in the TF2 / optax composition (see the module
    docstring); ``momentum=None`` or 0 leaves the trace out."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 rho: float, eps: float, momentum: Optional[float] = None):
        super().__init__(params, {"lr": lr, "rho": rho, "eps": eps,
                                  "momentum": momentum})

    def _update(self, group, state, param, grad):
        rho, eps, lr = group["rho"], group["eps"], group["lr"]
        momentum = group["momentum"]
        if not state:
            state["nu"] = torch.zeros_like(param)
            if momentum:
                state["trace"] = torch.zeros_like(param)
        nu = state["nu"]
        nu.copy_((1.0 - rho) * (grad * grad) + rho * nu)
        update = -lr * (torch.rsqrt(nu + eps) * grad)
        if momentum:
            trace = state["trace"]
            trace.copy_(update + momentum * trace)
            update = trace
        return update


class Adagrad(_ElementwiseOptimizer):
    """optax's ``adagrad``: a sum of squared gradients started at
    ``initial_accumulator_value``, and the update ``-lr g / sqrt(sum +
    eps)``, epsilon inside the root.  ``torch.optim.Adagrad`` counts its
    steps on the host and has no capturable form, so the port computes
    optax's update itself (optax's guard for a zero sum is not needed: the
    sum starts above 0, or the gradient there is 0 and so is the
    update)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, {
            "lr": lr, "initial_accumulator_value": initial_accumulator_value,
            "eps": eps})

    def _update(self, group, state, param, grad):
        if not state:
            state["sum_of_squares"] = torch.full_like(
                param, group["initial_accumulator_value"])
        sums = state["sum_of_squares"]
        sums.add_(grad * grad)
        return -group["lr"] * (torch.rsqrt(sums + group["eps"]) * grad)


#: The optax optimizers that ``torch.optim`` computes, by lowercase name:
#: the class and optax's defaults as its arguments.
OPTAX_DEFAULTS: Dict[str, Tuple[type, Dict[str, object]]] = {
    "adam": (torch.optim.Adam, {"betas": (0.9, 0.999), "eps": 1e-8}),
    "adamw": (torch.optim.AdamW, {"betas": (0.9, 0.999), "eps": 1e-8,
                                  "weight_decay": 1e-4}),
    "adamax": (torch.optim.Adamax, {"betas": (0.9, 0.999), "eps": 1e-8}),
    "adagrad": (Adagrad, {"initial_accumulator_value": 0.1, "eps": 1e-7}),
    "adadelta": (torch.optim.Adadelta, {"rho": 0.9, "eps": 1e-6}),
    "rmsprop": (RMSprop, {"rho": 0.9, "eps": 1e-8}),
    "sgd": (torch.optim.SGD, {}),
}

#: The classes built with ``capturable=True`` for CUDA parameters.
CAPTURABLE = (torch.optim.Adam, torch.optim.AdamW, torch.optim.Adamax,
              torch.optim.Adadelta)


def _on_cuda(params: list) -> bool:
    first = params[0]["params"][0] if isinstance(params[0], dict) \
        else params[0]
    return first.device.type == "cuda"


def _build(cls: type, params: Iterable, **kwargs) -> torch.optim.Optimizer:
    """``cls(params, **kwargs)``, capturable on CUDA where ``cls`` needs
    it (:data:`CAPTURABLE`)."""
    params = list(params)
    if cls in CAPTURABLE and params and _on_cuda(params):
        kwargs["capturable"] = True
    return cls(params, **kwargs)


def get_optimizer(options: Options, params: Iterable[torch.Tensor]
                  ) -> torch.optim.Optimizer:
    """The optimizer named by ``options.optimizer`` over ``params``."""
    name = str(options.optimizer)
    if name == "RMSprop":
        return RMSprop(params, lr=options.learning_rate, rho=options.rho,
                       eps=options.epsilon,
                       momentum=options.momentum or None)
    if name == "Adam":
        return _build(torch.optim.Adam, params, lr=options.learning_rate,
                      betas=(options.momentum, options.rho),
                      eps=options.epsilon)
    if name.lower() not in OPTAX_DEFAULTS:
        raise ValueError(f"unknown optimizer {name!r}: RMSprop, Adam and "
                         f"the optax names {sorted(OPTAX_DEFAULTS)} are "
                         "ported")
    cls, defaults = OPTAX_DEFAULTS[name.lower()]
    return _build(cls, params, lr=options.learning_rate, **defaults)


def fleet_optimizer(name: str,
                    trials: Sequence[Tuple[Iterable[torch.Tensor],
                                           Dict[str, float]]]
                    ) -> torch.optim.Optimizer:
    """One optimizer over a fleet of trials, a param group each.

    ``trials`` pairs each trial's parameters with its hyperparameters
    ``learning_rate``, ``rho``, ``epsilon`` and ``momentum``; every group
    takes its own, as ``optax.inject_hyperparams`` gives each vmapped
    trial its own (``hpo/vmapped.py:35-54``): RMSprop ``lr``, ``rho``,
    ``eps`` and ``momentum``, Adam ``lr``, ``betas=(momentum, rho)`` and
    ``eps``.  ``name`` is ``RMSprop`` or ``Adam`` (the TF names, as the
    JAX fleet's); any other raises ``ValueError``.  Adam on CUDA is
    capturable.  Both skip a parameter that has no gradient, so a frozen
    trial, which computes none, takes no step: its parameters stay exactly
    where they stopped (the JAX fleet's zero-masked update).
    """
    def group(params, hp):
        common = {"params": list(params), "lr": hp["learning_rate"],
                  "eps": hp["epsilon"]}
        if name == "RMSprop":
            return {**common, "rho": hp["rho"], "momentum": hp["momentum"]}
        return {**common, "betas": (hp["momentum"], hp["rho"])}

    if name not in ("RMSprop", "Adam"):
        raise ValueError(f"parallel trials support RMSprop/Adam, got "
                         f"{name!r}")
    groups = [group(params, hp) for params, hp in trials]
    if name == "RMSprop":
        first = groups[0]
        return RMSprop(groups, lr=first["lr"], rho=first["rho"],
                       eps=first["eps"], momentum=first["momentum"])
    return _build(torch.optim.Adam, groups)
