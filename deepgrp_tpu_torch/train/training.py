"""Training loop.

Counterpart of ``deepgrp_tpu/train/training.py`` (reference behaviour: the
reference DeepGRP's ``training.py:15-73``): a loop of ``n_epochs`` epochs
of ``n_batches`` optimization steps, one validation batch per epoch, early
stopping on ``val_loss`` with patience ``early_stopping_th`` and
restoration of the best weights, best-only checkpoints in ``logdir``, and
metrics in ``logdir/metrics.jsonl`` and TensorBoard event files.

One optimization step (:func:`train_step`): class-balanced code windows
and labels gathered on the device, Keras input-dropout masks, the forward
and the attention + dense head, categorical cross-entropy from logits
(``log_softmax``, numerically equivalent to the reference's CCE on the
softmax but stable), the backward, and the optimizer update.  On the fused
route (the default) the recurrence runs through the training kernels'
autograd Function, the backward through the backward kernel; on the scan
route the windows go one-hot through the model's one-hot recurrence, a
plain loop differentiated by autograd, as the JAX package's scan route
runs XLA's scan under ``jax.grad``.

Within an epoch nothing waits for the device: windows and masks are drawn
from one ``torch.Generator`` on the device and the losses stay there; the
host reads them once per epoch.  On a CUDA device the step (draw, masks,
forward, loss, backward, optimizer) is captured as a CUDA graph after one
eager warm-up step and replayed for every later step (:class:`EpochLoop`,
:class:`~deepgrp_tpu_torch.train.step_graph.StepGraph`): the counterpart
of the JAX package's one dispatch per epoch.  The validation batch runs
without dropout, through the inference kernels, eagerly between epochs.

With a process group of several ranks the loop is data-parallel
(:class:`Trainer`'s ``group``; the epoch is
:func:`deepgrp_tpu_torch.parallel.train.make_dp_train_epoch`, its step
:func:`~deepgrp_tpu_torch.parallel.train.dp_train_step`).  Over NCCL it
is captured as well, the gradient ``all_reduce`` inside the graph; over
gloo, whose collectives run on the host, it stays eager.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.data.preprocess import Data
from deepgrp_tpu_torch.models import rnn
from deepgrp_tpu_torch.models.convert import params_from_jax, params_to_jax
from deepgrp_tpu_torch.models.model import (
    DeepGRPModel, ModelConfig, forward_logits_from_codes,
    forward_logits_from_codes_train, init_params, one_hot,
    resolve_rnn_kernel)
from deepgrp_tpu_torch.parallel.mesh import cuda_backend, is_first_rank
from deepgrp_tpu_torch.train.checkpoint import CheckpointManager, load_params
from deepgrp_tpu_torch.train.optimizers import get_optimizer
from deepgrp_tpu_torch.train.sampler import BatchSampler, local_batch_size
from deepgrp_tpu_torch.train.step_graph import StepGraph
from deepgrp_tpu_torch.utils.tb_events import EventFileWriter

_LOG = logging.getLogger(__name__)

MetricCallback = Callable[[int, Dict[str, float]], None]
Params = Dict[str, torch.Tensor]


def categorical_crossentropy(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Mean categorical cross-entropy over batch and positions."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels * log_probs, dim=-1))


class MetricsWriter:
    """JSONL metrics log (``metrics.jsonl``, one record a call with the
    keys ``step``, ``time`` and the metrics), mirrored into TensorBoard
    scalar events with ``tensorboard=True`` (``training.py:50-84``) through
    :class:`~deepgrp_tpu_torch.utils.tb_events.EventFileWriter`, each
    event stamped with its record's ``time``."""

    def __init__(self, logdir: os.PathLike, tensorboard: bool = False):
        self.logdir = os.fspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)
        self._file = open(os.path.join(self.logdir, "metrics.jsonl"), "a")
        self._tb = EventFileWriter(self.logdir) if tensorboard else None

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": step, "time": time.time(), **metrics}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            for key, value in metrics.items():
                self._tb.add_scalar(key, value, step, record["time"])

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def step_loss(model: DeepGRPModel, codes: torch.Tensor,
              labels: torch.Tensor, masks: Optional[torch.Tensor],
              fused: bool = True) -> torch.Tensor:
    """The training loss of one batch, for autograd.

    ``fused``: the recurrence runs through the training kernels
    (:func:`~deepgrp_tpu_torch.models.model.
    forward_logits_from_codes_train`); else the scan route
    (``training.py:120-127``): the code windows become one-hot rows (pad
    code 5 the all-zero row) and go through ``forward_logits(...,
    train=True)``, the plain loop differentiated by autograd.
    """
    if fused:
        logits = forward_logits_from_codes_train(model.params(), codes,
                                                 model.config, masks)
    else:
        logits = model.apply_logits(one_hot(codes, torch.float32),
                                    masks=masks, train=True)
    return categorical_crossentropy(logits, labels)


def train_step(model: DeepGRPModel, optimizer: torch.optim.Optimizer,
               codes: torch.Tensor, labels: torch.Tensor,
               masks: Optional[torch.Tensor],
               fused: bool = True) -> torch.Tensor:
    """One optimization step on explicit windows and masks.

    Args:
        model: the parameters (updated in place).
        optimizer: over ``model.parameters()``.
        codes: int8 code windows ``[B, T]``.
        labels: one-hot labels ``float32 [B, T, n_classes]``.
        masks: input dropout masks ``[g, 2B, 5]``, or ``None``.
        fused: the route (:func:`step_loss`).

    Returns:
        The batch loss, a 0-dim tensor on the model's device (not read).
    """
    optimizer.zero_grad(set_to_none=True)
    loss = step_loss(model, codes, labels, masks, fused)
    loss.backward()
    optimizer.step()
    return loss.detach()


class EpochLoop:
    """Epochs of a run's optimization steps, eager or, with ``capture``,
    replayed as one captured CUDA graph (:class:`~deepgrp_tpu_torch.train.
    step_graph.StepGraph` over ``generators``, the ones ``step`` draws
    from).

    ``step()`` takes one optimization step and returns its loss, a 0-dim
    device tensor.  The loss is copied into the static ``loss`` inside the
    step, then into row ``i`` of ``losses [n_batches]``; :meth:`epoch`
    returns ``losses.mean()``, the values and the reduction of
    ``torch.stack`` of the steps' losses ``.mean()``, not read.
    """

    def __init__(self, step: Callable[[], torch.Tensor], n_batches: int,
                 device: Union[str, torch.device], capture: bool = False,
                 generators: Sequence[torch.Generator] = ()):
        self.loss = torch.zeros((), device=device)
        self.losses = torch.zeros(n_batches, device=device)

        def body() -> None:
            self.loss.copy_(step())

        self._run: Callable[[], None] = (
            StepGraph(body, device, generators) if capture else body)

    def epoch(self) -> torch.Tensor:
        """``n_batches`` steps; their mean loss (a 0-dim device tensor)."""
        for i in range(self.losses.shape[0]):
            self._run()
            self.losses[i].copy_(self.loss)
        return self.losses.mean()


def host_params(model: DeepGRPModel) -> Params:
    """A CPU copy of the model's parameters."""
    return {key: value.detach().cpu().clone()
            for key, value in model.params().items()}


class Trainer:
    """The training loop of one model / options pair (``Trainer``,
    ``training.py:196-391``).

    ``capture``: replay the step as a captured CUDA graph
    (:class:`EpochLoop`); ``None`` (the default) captures on a CUDA device
    when the run has one rank or the group's collectives on CUDA tensors
    run over NCCL (``"nccl"``, or the default ``"cpu:gloo,cuda:nccl"``),
    and keeps a gloo group of several ranks eager; ``False`` runs every
    step eagerly (the reference a captured run equals bit for bit);
    ``True`` captures with any backend but gloo and raises ``ValueError``
    on the CPU or with a group of several ranks whose CUDA collectives run
    on gloo (the host, which a graph cannot hold), before any step or
    collective.
    """

    def __init__(self, model: DeepGRPModel, options: Options,
                 logdir: os.PathLike, tensorboard: bool = True,
                 rnn_kernel: str = "auto",
                 group: Optional[dist.ProcessGroup] = None,
                 capture: Optional[bool] = None):
        self.model = model
        self.options = options
        self.logdir = logdir
        self.fused = resolve_rnn_kernel(rnn_kernel)
        # Data-parallel over ``group`` when it has more than one rank
        # (``training.py:270-345``).
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        # The backend of the step's collectives (none with one rank).
        backend = cuda_backend(group) if self.world > 1 else None
        capturable = model.device.type == "cuda" and backend != "gloo"
        if capture and not capturable:
            raise ValueError(
                f"capture=True needs a CUDA device and collectives that run "
                f"on it; this run is on {model.device} with {self.world} "
                f"rank(s), CUDA collectives over {backend or 'none'}")
        self.capture = (capturable and backend in (None, "nccl")
                        if capture is None else capture)
        # The last fit's training generator (its state tells how far the
        # run's draws went).
        self.generator: Optional[torch.Generator] = None
        # In a multi-process run only the first rank writes files.
        writes = is_first_rank()
        self.checkpoints = CheckpointManager(logdir) if writes else None
        self.writer = (MetricsWriter(logdir, tensorboard=tensorboard)
                       if writes else None)

    def fit(self, train_data: Data, val_data: Data,
            params: Optional[Params] = None, seed: int = 0,
            callbacks: Optional[List[MetricCallback]] = None,
            resume: bool = False, stop_on_nan: bool = True
            ) -> Tuple[Params, Dict[str, List[float]]]:
        """Run the training loop; returns ``(best_params, history)``,
        the parameters on the CPU, and leaves the best ones in the model.

        ``params`` (flat, any device) start the run; else ``resume=True``
        starts from the latest checkpoint in ``logdir`` if there is one
        (with a fresh optimizer state); else Keras-default initial values
        drawn from ``seed``.  ``stop_on_nan`` ends the loop at the first
        epoch whose mean training loss is not finite.

        Data-parallel (``group`` of more than one rank): the first rank's
        starting parameters go to every rank; each step, rank ``r`` draws
        its ``batch_size / world`` windows (exact global class quotas,
        ``BatchSampler.sample_starts_dp``) and masks from a generator
        seeded from ``(seed, r)`` and takes :func:`~deepgrp_tpu_torch.
        parallel.train.dp_train_step`, in the epoch that
        ``make_dp_train_epoch`` builds (captured as the class docstring
        says; a failed capture raises).  Every rank draws the same
        validation batch (a generator seeded from ``seed``), scores its
        slice, and the losses are averaged by an ``all_reduce``, so every
        rank takes the same early-stopping and NaN decisions and returns
        the same history.
        """
        options, model = self.options, self.model
        config = model.config
        data_parallel = self.world > 1
        if data_parallel:
            from deepgrp_tpu_torch.parallel.train import (
                broadcast_params, make_dp_train_epoch)

            rank = dist.get_rank(self.group)
            # Raises before any collective, on every rank alike.
            local_batch = local_batch_size(options.batch_size, self.world)
        else:
            rank, local_batch = 0, int(options.batch_size)
        if params is None and resume and self.checkpoints is not None:
            latest = self.checkpoints.latest_path()
            if latest is not None:
                params = params_from_jax(load_params(latest))
                _LOG.info("resumed parameters from %s", latest)
        if params is None:
            params = init_params(config, torch.Generator().manual_seed(seed))
        model.load_state_dict(params)
        if data_parallel:
            broadcast_params(model, self.group)
        optimizer = get_optimizer(options, model.parameters())

        device = model.device
        generator = torch.Generator(device=device).manual_seed(
            seed * 65537 + rank if data_parallel else seed)
        val_generator = (torch.Generator(device=device).manual_seed(seed)
                         if data_parallel else generator)
        self.generator = generator
        train_sampler = BatchSampler(options, train_data, device)
        val_sampler = BatchSampler(options, val_data, device)
        if data_parallel:
            loop = make_dp_train_epoch(model, optimizer, options,
                                       train_sampler, generator,
                                       options.n_batches, self.group,
                                       self.fused, self.capture)
        else:
            rows, rate = 2 * local_batch, float(config.dropout)

            def step() -> torch.Tensor:
                codes, labels = train_sampler.batch(generator)
                masks = (rnn.input_dropout_masks(generator, rows, rate,
                                                 config.gates)
                         if rate > 0.0 else None)
                return train_step(model, optimizer, codes, labels, masks,
                                  self.fused)

            loop = EpochLoop(step, options.n_batches, device, self.capture,
                             [generator])
        history: Dict[str, List[float]] = {"loss": [], "val_loss": []}
        best_val = math.inf
        best_params = host_params(model)
        patience = 0
        for epoch in range(1, options.n_epochs + 1):
            epoch_t0 = time.time()
            train_loss = loop.epoch().item()
            if stop_on_nan and not math.isfinite(train_loss):
                _LOG.warning("non-finite training loss at epoch %d; "
                             "stopping and restoring best weights", epoch)
                break

            with torch.no_grad():
                val_starts = val_sampler.sample_starts(val_generator)
                val_starts = val_starts[rank * local_batch:
                                        (rank + 1) * local_batch]
                val_codes, val_labels = val_sampler.gather(val_starts)
                val_loss = categorical_crossentropy(
                    forward_logits_from_codes(model.params(), val_codes,
                                              config), val_labels)
                if data_parallel:
                    dist.all_reduce(val_loss, group=self.group)
                    val_loss /= self.world
                val_loss = val_loss.item()

            history["loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            metrics = {"loss": train_loss, "val_loss": val_loss,
                       "epoch_seconds": time.time() - epoch_t0}
            if self.writer is not None:
                self.writer.write(epoch, metrics)
            for callback in callbacks or []:
                callback(epoch, metrics)
            _LOG.info("epoch %d: loss=%.5f val_loss=%.5f", epoch,
                      train_loss, val_loss)

            if val_loss < best_val:
                best_val = val_loss
                best_params = host_params(model)
                if self.checkpoints is not None:
                    self.checkpoints.save(epoch, params_to_jax(best_params))
                patience = 0
            else:
                patience += 1
                if patience >= options.early_stopping_th:
                    _LOG.info("early stopping at epoch %d", epoch)
                    break

        # EarlyStopping(restore_best_weights=True) semantics.
        model.load_state_dict(best_params)
        return best_params, history


def training(data: Tuple[Data, Data], options: Options,
             model: Optional[DeepGRPModel] = None,
             logdir: os.PathLike = ".",
             extra_callbacks: Optional[List[MetricCallback]] = None,
             params: Optional[Params] = None, seed: int = 0,
             device: str = "cuda", tensorboard: bool = True,
             rnn_kernel: str = "auto",
             group: Optional[dist.ProcessGroup] = None
             ) -> Tuple[Params, Dict[str, List[float]]]:
    """Functional API mirroring the reference ``training()``
    (training.py:15-73).  Returns ``(best_params, history)``.

    ``model`` defaults to a new model of ``options`` on ``device``.
    ``tensorboard`` (default on, as the reference's TensorBoard callback
    always runs) mirrors the metrics into event files beside
    ``metrics.jsonl``; ``rnn_kernel`` picks the step's route
    (auto|scan|fused, :func:`~deepgrp_tpu_torch.models.model.
    resolve_rnn_kernel`); ``group`` trains data-parallel over its ranks
    (:class:`Trainer`).
    """
    if model is None:
        model = DeepGRPModel(ModelConfig.from_options(options), device)
    trainer = Trainer(model, options, logdir, tensorboard=tensorboard,
                      rnn_kernel=rnn_kernel, group=group)
    try:
        return trainer.fit(data[0], data[1], params=params, seed=seed,
                           callbacks=extra_callbacks)
    finally:
        if trainer.writer is not None:
            trainer.writer.close()
