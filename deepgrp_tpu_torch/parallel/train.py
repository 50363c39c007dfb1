"""Data-parallel training step and epoch over ``torch.distributed``.

Counterpart of ``deepgrp_tpu/parallel/train.py``.  The JAX step runs
inside ``shard_map``: each device samples its slice of the class-balanced
batch, computes local gradients, ``pmean``s them over the mesh and applies
the replicated update.  Here each rank is a process with its own replica
of the model: it draws its slice (``BatchSampler.sample_starts_dp``),
runs the local loss and backward through the training kernels, and the
gradients and the loss are averaged by **one** ``all_reduce`` of one flat
buffer a step, in the model's parameter order, before the same update on
every rank.  The explicit form keeps the order of the step's sums fixed
(DDP's buckets would not), as the kernels' own sums are.

:func:`make_dp_train_epoch` is the counterpart of the JAX package's
``make_dp_train_epoch`` (``n_steps`` DP steps as one ``lax.scan`` inside
``shard_map``, the ``pmean`` inside the scan): a rank's epoch as an
:class:`~deepgrp_tpu_torch.train.training.EpochLoop` whose step draws the
rank's windows and masks and takes :func:`dp_train_step`, eager or
captured as one CUDA graph with the ``all_reduce`` inside.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.models import rnn
from deepgrp_tpu_torch.models.model import DeepGRPModel
from deepgrp_tpu_torch.train.sampler import BatchSampler, local_batch_size
from deepgrp_tpu_torch.train.training import EpochLoop, step_loss


def _flat(params: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in params])


def _unflat(flat: torch.Tensor, params: List[torch.Tensor]) -> None:
    offset = 0
    for param in params:
        param.copy_(flat[offset:offset + param.numel()].view_as(param))
        offset += param.numel()


def dp_train_step(model: DeepGRPModel, optimizer: torch.optim.Optimizer,
                  codes: torch.Tensor, labels: torch.Tensor,
                  masks: Optional[torch.Tensor],
                  group: Optional[dist.ProcessGroup] = None,
                  fused: bool = True) -> torch.Tensor:
    """One data-parallel optimization step on this rank's windows.

    Args:
        model: this rank's replica (updated in place, the same update on
            every rank).
        optimizer: over ``model.parameters()``.
        codes, labels, masks: this rank's windows, one-hot labels and
            dropout masks, as :func:`~deepgrp_tpu_torch.train.training.
            train_step` takes them.
        group: the process group (default: the default group).
        fused: the route (:func:`~deepgrp_tpu_torch.train.training.
            step_loss`).

    Returns:
        The loss averaged over the ranks, a 0-dim tensor on the model's
        device (not read).
    """
    world = dist.get_world_size(group)
    optimizer.zero_grad(set_to_none=True)
    loss = step_loss(model, codes, labels, masks, fused)
    loss.backward()
    params = list(model.parameters())
    for param in params:
        if param.grad is None:  # every rank sums the same layout
            param.grad = torch.zeros_like(param)
    grads = [param.grad for param in params]
    flat = torch.cat([_flat(grads), loss.detach().reshape(1)])
    dist.all_reduce(flat, group=group)
    flat /= world
    with torch.no_grad():
        _unflat(flat[:-1], grads)
    optimizer.step()
    return flat[-1]


def make_dp_train_epoch(model: DeepGRPModel,
                        optimizer: torch.optim.Optimizer, options: Options,
                        train_sampler: BatchSampler,
                        generator: torch.Generator, n_steps: int,
                        group: Optional[dist.ProcessGroup] = None,
                        fused: bool = True,
                        capture: bool = False) -> EpochLoop:
    """This rank's data-parallel epoch of ``n_steps`` steps.

    Each step draws the rank's ``batch_size / world`` window starts
    (``train_sampler.sample_starts_dp(generator, rank, world)``), then its
    dropout masks from the same ``generator``, and takes
    :func:`dp_train_step` over ``group``.  With ``capture`` the step is
    replayed as a captured CUDA graph (:class:`~deepgrp_tpu_torch.train.
    step_graph.StepGraph` over ``generator``), the ``all_reduce`` inside
    it; ``capture`` needs the group's collectives on CUDA tensors to run
    on the card (NCCL, or a backend that makes no host call), which the
    caller checks (``Trainer``).

    The capture keeps ``capture_error_mode="global"``, as a
    single-device step's does.  ``ProcessGroupNCCL``'s watchdog thread
    polls the CUDA events of the collectives issued before the capture
    (the parameters' broadcast, the warm-up step's ``all_reduce``, the
    last validation's) on its own schedule; a query of an event recorded
    outside the capture is no unsafe call, and the collectives captured
    are not handed to the watchdog.  The communicator exists before the
    capture (the broadcast, the warm-up step).  The ``all_reduce`` is
    synchronous, so NCCL's stream joins the capturing stream again before
    the capture ends.

    The graph belongs to the returned loop; nothing is cached.
    """
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    config = model.config
    rows = 2 * local_batch_size(options.batch_size, world)
    rate = float(config.dropout)

    def step() -> torch.Tensor:
        codes, labels = train_sampler.gather(
            train_sampler.sample_starts_dp(generator, rank, world))
        masks = (rnn.input_dropout_masks(generator, rows, rate,
                                         config.gates)
                 if rate > 0.0 else None)
        return dp_train_step(model, optimizer, codes, labels, masks, group,
                             fused)

    return EpochLoop(step, n_steps, model.device, capture, [generator])


@torch.no_grad()
def broadcast_params(model: DeepGRPModel,
                     group: Optional[dist.ProcessGroup] = None) -> None:
    """Give every rank the parameters of the group's first rank (one
    ``broadcast`` of one flat buffer)."""
    params = list(model.parameters())
    flat = _flat([p.detach() for p in params])
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(flat, src=src, group=group)
    _unflat(flat, params)
