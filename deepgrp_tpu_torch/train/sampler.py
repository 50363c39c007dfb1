"""Class-balanced window sampler, on the device.

Counterpart of ``deepgrp_tpu/train/sampler.py`` (reference semantics:
the reference DeepGRP's ``training.py:76-132``).  Per repeat class, the
candidate window starts are the positions whose ``vecsize`` window overlaps
a labelled position (``calc_indices``); each batch draws exactly
``one_class_size = int(batch_size * repeat_probability / n_repeat_classes)``
starts of every class with more candidates than that, fills the rest
uniformly from ``[0, seq_len - vecsize)`` and shuffles.

The candidate lists are computed once on the host and padded into one
``[n_classes, max_candidates]`` device matrix; the code track (one byte a
position) and the labels stay on the device, so sampling and the window
gathers are device work drawn from a ``torch.Generator`` on the device.
The random streams differ from the JAX package's (threefry), so parity is
by distribution, as it is with the reference's unseeded numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deepgrp_tpu_torch.config import Options
from deepgrp_tpu_torch.data.preprocess import Data

PAD_CODE = 5


def calc_indices(array: np.ndarray, vecsize: int) -> np.ndarray:
    """Candidate window starts overlapping labeled positions
    (training.py:76-81 parity, including the ``> 0`` start filter)."""
    sums = array.cumsum()
    sums[vecsize:] = sums[vecsize:] - sums[:-vecsize]
    indices = np.where(sums > 0)[0] - vecsize
    indices = indices[indices > 0]
    return indices


def codes_from_onehot_rows(fwd: np.ndarray) -> np.ndarray:
    """One-hot sequence ``[5, L]`` -> code track ``int8 [L]`` (A=0..T=3,
    N=4); all-zero columns (hard-masked positions) become the pad code 5,
    which selects no input row (``deepgrp_tpu/train/training.py:137``)."""
    occupied = fwd.sum(axis=0) > 0
    return np.where(occupied, fwd.argmax(axis=0), PAD_CODE).astype(np.int8)


def local_batch_size(batch_size: int, world: int) -> int:
    """A rank's share of a data-parallel batch; raises ``ValueError``
    when ``batch_size`` does not divide by ``world``
    (``parallel/train.py:38-41``)."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"{world} ranks")
    return batch_size // world


class BatchSampler:
    """Batch sampler bound to one dataset, on one device."""

    def __init__(self, options: Options, data: Data,
                 device: torch.device):
        self.device = torch.device(device)
        self.vecsize = int(options.vecsize)
        self.batch_size = int(options.batch_size)
        n_label_rows = data.truelbl.shape[0]
        self.n_classes = n_label_rows
        self.one_class_size = int(options.batch_size *
                                  options.repeat_probability /
                                  (n_label_rows - 1))
        self.seq_len = int(data.fwd.shape[1])

        candidates = [
            calc_indices(np.asarray(data.truelbl[i]), self.vecsize)
            for i in range(1, n_label_rows)
        ]
        candidates = [c for c in candidates if c.size > self.one_class_size]
        self.n_sampled_classes = len(candidates)
        self.filled = self.one_class_size * len(candidates)
        if self.filled > self.batch_size:
            raise ValueError("repeat_probability * batch_size exceeds batch")

        max_len = max((c.size for c in candidates), default=1)
        cand = np.zeros((max(len(candidates), 1), max_len), dtype=np.int64)
        lens = np.ones(max(len(candidates), 1), dtype=np.int64)
        for i, c in enumerate(candidates):
            cand[i, :c.size] = c
            lens[i] = c.size
        self.candidates = torch.from_numpy(cand).to(self.device)
        self.lengths = torch.from_numpy(lens).to(self.device)
        self.codes = torch.from_numpy(
            codes_from_onehot_rows(np.asarray(data.fwd))).to(self.device)
        self.labels = torch.from_numpy(np.ascontiguousarray(
            np.asarray(data.truelbl).T, dtype=np.int8)).to(self.device)
        self._offsets = torch.arange(self.vecsize, device=self.device)

    def sample_starts(self, generator: torch.Generator) -> torch.Tensor:
        """A shuffled ``[batch_size]`` int64 vector of window starts
        (``_sample_starts``, ``sampler.py:96-110``)."""
        parts = []
        n_sampled, ocs = self.n_sampled_classes, self.one_class_size
        if n_sampled and ocs:
            picks = torch.randint(0, 1 << 30, (n_sampled, ocs),
                                  generator=generator, device=self.device)
            picks = picks % self.lengths[:n_sampled, None]
            parts.append(self.candidates[:n_sampled].gather(1, picks)
                         .reshape(-1))
        n_uniform = self.batch_size - n_sampled * ocs
        if n_uniform:
            parts.append(torch.randint(0, self.seq_len - self.vecsize,
                                       (n_uniform,), generator=generator,
                                       device=self.device))
        starts = torch.cat(parts)
        return starts[torch.randperm(self.batch_size, generator=generator,
                                     device=self.device)]

    def sample_starts_dp(self, generator: torch.Generator, rank: int,
                         world: int) -> torch.Tensor:
        """Rank ``rank``'s shuffled ``[batch_size // world]`` window starts
        of a data-parallel batch with exact global class quotas
        (``_sample_starts_dp``, ``sampler.py:114-160``).

        The ``n_sampled * one_class_size`` class slots of the global batch
        are numbered class-major (slot ``g`` belongs to class ``g //
        one_class_size``) and striped over the ranks: rank ``r`` samples
        slots ``r * slots + j`` for ``j < slots = ceil(filled / world)``
        and turns those past the end into uniform starts.  Summed over the
        ranks each class gets exactly ``one_class_size`` starts, as in one
        process; the rest of each rank's batch is uniform.  ``generator``
        is the rank's own (it takes the place of the JAX key's
        ``fold_in`` of the device index).
        """
        local_batch = local_batch_size(self.batch_size, world)
        n_sampled, ocs = self.n_sampled_classes, self.one_class_size
        filled = n_sampled * ocs
        slots = -(-filled // world) if filled else 0
        if slots > local_batch:
            raise ValueError(f"per-rank batch {local_batch} cannot hold "
                             f"ceil({filled}/{world}) class-balanced slots")
        high = self.seq_len - self.vecsize
        parts = []
        if slots:
            slot = rank * slots + torch.arange(slots, device=self.device)
            cls = (slot // ocs).clamp(0, n_sampled - 1)
            picks = torch.randint(0, 1 << 30, (slots,), generator=generator,
                                  device=self.device) % self.lengths[cls]
            fill = torch.randint(0, high, (slots,), generator=generator,
                                 device=self.device)
            parts.append(torch.where(slot < filled,
                                     self.candidates[cls, picks], fill))
        if local_batch > slots:
            parts.append(torch.randint(0, high, (local_batch - slots,),
                                       generator=generator,
                                       device=self.device))
        starts = torch.cat(parts)
        return starts[torch.randperm(local_batch, generator=generator,
                                     device=self.device)]

    def gather(self, starts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Windows at ``starts``: codes ``int8 [B, V]`` and one-hot labels
        ``float32 [B, V, n_classes]``."""
        index = starts[:, None] + self._offsets
        return self.codes[index], self.labels[index].to(torch.float32)

    def batch(self, generator: torch.Generator
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One class-balanced batch ``(codes, labels)``."""
        return self.gather(self.sample_starts(generator))
