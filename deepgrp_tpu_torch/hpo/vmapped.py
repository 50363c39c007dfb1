"""Parallel HPO trials: a fleet of same-architecture trials trained in
lockstep.

Counterpart of ``deepgrp_tpu/hpo/vmapped.py``.  Trials that share an
architecture (vecsize, units, rnn type, attention, batch size,
repeat_probability) but vary in continuous hyperparameters
(``VARYING_KEYS``: learning_rate, momentum, rho, epsilon, dropout) train
together: one fleet step advances every trial that has not stopped, one
validation batch an epoch serves them all, and each trial stops early on
its own.

The JAX package ``vmap``s the step over a trial axis, which forces it onto
the one-hot scan route (the per-trial dropout rate must be traced).  On
the card, a ctypes kernel cannot be batched by ``torch.func.vmap``, and
autograd through the plain loop would take the fleet off the kernels, so
here each fleet step runs every active trial's step in turn through the
fused training kernels, on one stream (:func:`fleet_step`): its own
parameters, its own param group in one optimizer
(:func:`~deepgrp_tpu_torch.train.optimizers.fleet_optimizer`), and its own
windows and masks from its own ``torch.Generator``.  Validation runs
through the inference kernels.  With one-hot input ``(x * mask_g) @ W_g``
equals the fused row select ``mask_g[b, code] * W_g[code]``, so the two
routes compute the same function and differ only in the summation order of
the recurrent dot.

On a CUDA device a fleet step (every active trial's draw, masks, forward
and backward, then the one optimizer step) is captured as one CUDA graph
after an eager warm-up step and replayed (:func:`fleet_steps`,
:class:`~deepgrp_tpu_torch.train.step_graph.StepGraph`), the counterpart
of the JAX fleet's one program a step.  The active set changes only
between epochs; a freeze drops the graph and captures one of the new set.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.data.preprocess import Data
from deepgrp_tpu_torch.models import rnn
from deepgrp_tpu_torch.models.model import (DeepGRPModel, ModelConfig,
                                            forward_logits_from_codes,
                                            init_params, resolve_device)
from deepgrp_tpu_torch.train.optimizers import fleet_optimizer
from deepgrp_tpu_torch.train.sampler import BatchSampler
from deepgrp_tpu_torch.train.step_graph import StepGraph
from deepgrp_tpu_torch.train.training import (categorical_crossentropy,
                                              host_params, step_loss)

VARYING_KEYS = ("learning_rate", "momentum", "rho", "epsilon", "dropout")

# (code windows [B, T], one-hot labels [B, T, C], masks [g, 2B, 5] or None)
Batch = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def stack_trial_hyperparams(base: Options,
                            trial_dicts: List[Dict[str, Any]]
                            ) -> Dict[str, np.ndarray]:
    """Dense float32 ``[n_trials]`` arrays of each varying hyperparameter
    (a trial's own value, else the base options')."""
    out = {}
    for key in VARYING_KEYS:
        out[key] = np.array(
            [float(t.get(key, base[key])) for t in trial_dicts],
            dtype=np.float32)
    return out


def trial_hyperparams(hp: Dict[str, np.ndarray],
                      index: int) -> Dict[str, float]:
    """Trial ``index``'s hyperparameters from the stacked arrays (float32
    values, as the JAX fleet's traced ones are)."""
    return {key: float(values[index]) for key, values in hp.items()}


def fleet_step(models: Sequence[DeepGRPModel],
               optimizer: torch.optim.Optimizer,
               batches: Sequence[Optional[Batch]],
               active: Sequence[bool]) -> List[Optional[torch.Tensor]]:
    """One fleet step (``_parallel_step``, ``vmapped.py:71-114``).

    Each active trial's loss and backward run in turn on its batch,
    through the fused training kernels (their plain versions on the CPU);
    then one optimizer step updates every group that has gradients.  A
    trial with ``active=False`` computes nothing, so its group takes no
    step and its parameters stay bit for bit.  Returns each trial's loss
    (a 0-dim device tensor, not read) or ``None`` for a frozen trial.
    """
    optimizer.zero_grad(set_to_none=True)
    losses: List[Optional[torch.Tensor]] = []
    for model, batch, on in zip(models, batches, active):
        if not on:
            losses.append(None)
            continue
        loss = step_loss(model, *batch)
        loss.backward()
        losses.append(loss.detach())
    optimizer.step()
    return losses


def fleet_steps(models: Sequence[DeepGRPModel],
                optimizer: torch.optim.Optimizer,
                batch: Callable[[int], Batch], active: Sequence[bool],
                losses: torch.Tensor) -> Callable[[], None]:
    """The fleet step of one active set as a function of no arguments
    (what a :class:`~deepgrp_tpu_torch.train.step_graph.StepGraph`
    captures): each active trial's batch (``batch(i)``, in trial order),
    :func:`fleet_step`, and each active trial's loss copied into
    ``losses[i]`` (a frozen trial's row keeps its value)."""
    active = [bool(on) for on in active]

    def step() -> None:
        out = fleet_step(models, optimizer,
                         [batch(i) if on else None
                          for i, on in enumerate(active)], active)
        for i, loss in enumerate(out):
            if loss is not None:
                losses[i].copy_(loss)

    return step


def _trial_seed(seed: int, *path: int) -> int:
    """The seed of one stream of the fleet seeded ``seed``."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1)[0])


def run_parallel_trials(base_options: Options,
                        trial_dicts: List[Dict[str, Any]],
                        train_data: Data, val_data: Data,
                        seed: int = 0,
                        device: Union[str, torch.device] = "cuda",
                        capture: Optional[bool] = None
                        ) -> List[Dict[str, Any]]:
    """Train every trial of the fleet; per-trial results
    (``run_parallel_trials``, ``vmapped.py:125-231``).

    Each result: ``{"val_loss": best, "val_history": [...], "params": best
    flat parameters (CPU tensors), "stopped_epoch": last active epoch}``.
    Trial ``i`` draws its initial parameters, windows and masks from the
    seeds ``(seed, 0, i)``; the shared validation batches come from
    ``(seed, 1)``.  Early stopping is per trial: a trial whose patience
    (``early_stopping_th``, at least 1) is spent is frozen, and the fleet
    stops when every trial is.  ``capture`` replays each fleet step as a
    captured CUDA graph (module docstring); ``None`` (the default) captures
    on a CUDA device, ``False`` runs every step eagerly, ``True`` raises
    ``ValueError`` on the CPU.  Raises ``ValueError`` for a trial dict
    with a key outside ``VARYING_KEYS``.
    """
    n_trials = len(trial_dicts)
    if n_trials == 0:
        return []
    for t in trial_dicts:
        extra = set(t) - set(VARYING_KEYS)
        if extra:
            raise ValueError(
                f"parallel trials can only vary {VARYING_KEYS}, got {extra}")

    options = base_options
    device = resolve_device(device)
    if capture is None:
        capture = device.type == "cuda"
    elif capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, not {device}")
    config = ModelConfig.from_options(options)
    hp = stack_trial_hyperparams(options, trial_dicts)
    trial_hp = [trial_hyperparams(hp, i) for i in range(n_trials)]
    models = [DeepGRPModel.from_params(
        config, init_params(config, torch.Generator().manual_seed(
            _trial_seed(seed, 0, i))), device) for i in range(n_trials)]
    optimizer = fleet_optimizer(
        str(options.optimizer),
        [(model.parameters(), trial_hp[i]) for i, model in enumerate(models)])
    generators = [torch.Generator(device=device).manual_seed(
        _trial_seed(seed, 0, i)) for i in range(n_trials)]
    val_generator = torch.Generator(device=device).manual_seed(
        _trial_seed(seed, 1))

    train_sampler = BatchSampler(options, train_data, device)
    val_sampler = BatchSampler(options, val_data, device)
    rows = 2 * train_sampler.batch_size

    def batch(i: int) -> Batch:
        codes, labels = train_sampler.batch(generators[i])
        rate = trial_hp[i]["dropout"]
        masks = (rnn.input_dropout_masks(generators[i], rows, rate,
                                         config.gates)
                 if rate > 0.0 else None)
        return codes, labels, masks

    best_val = np.full(n_trials, np.inf)
    best_params = [host_params(model) for model in models]
    history: List[np.ndarray] = []
    # Patience < 1 would freeze every trial before epoch 1's validation
    # is recorded (val_loss=inf, untrained params); clamp so the first
    # epoch always counts, as the serial trainer does.
    patience = max(int(options.early_stopping_th), 1)
    since_best = np.zeros(n_trials, np.int64)
    stopped_epoch = np.zeros(n_trials, np.int64)

    losses = torch.zeros(n_trials, device=device)
    run: Optional[Callable[[], None]] = None
    run_active = None
    for epoch in range(1, options.n_epochs + 1):
        active = since_best < patience
        if run is None or not np.array_equal(active, run_active):
            # A freeze drops the old graph (run's last reference).
            step = fleet_steps(models, optimizer, batch, active, losses)
            run = (StepGraph(step, device, [generators[i] for i in
                                            np.flatnonzero(active)])
                   if capture else step)
            run_active = active
        for _ in range(options.n_batches):
            run()
        val_codes, val_labels = val_sampler.batch(val_generator)
        with torch.no_grad():
            val_losses = torch.stack([
                categorical_crossentropy(
                    forward_logits_from_codes(model.params(), val_codes,
                                              config), val_labels)
                for model in models]).cpu().numpy().astype(np.float64)
        history.append(val_losses)
        # Frozen trials record no further improvements (their params no
        # longer move; an apparent gain would be validation-batch noise).
        improved = (val_losses < best_val) & active
        since_best = np.where(improved, 0, since_best + active)
        stopped_epoch = np.where(active, epoch, stopped_epoch)
        for i in np.flatnonzero(improved):
            best_params[i] = host_params(models[i])
        best_val = np.where(improved, val_losses, best_val)
        if not (since_best < patience).any():
            break

    stacked_history = np.stack(history)
    return [{"val_loss": float(best_val[i]),
             "val_history": stacked_history[:, i].tolist(),
             "params": best_params[i],
             "stopped_epoch": int(stopped_epoch[i])}
            for i in range(n_trials)]
