"""Data-parallel training step over ``torch.distributed``.

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
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from deepgrp_tpu_torch.models.model import DeepGRPModel
from deepgrp_tpu_torch.train.training import step_loss


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
