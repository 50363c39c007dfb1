"""Sharded genome-scale prediction over several devices and processes.

Counterpart of ``deepgrp_tpu/parallel/predict.py``
(``ShardedPredictionEngine``).  The chromosome's window chunks are split
into contiguous ranges, one a shard.  Shard ``d`` owns windows ``[d*R,
(d+1)*R)``, ``R = chunks_per_shard * batch``, and holds only the code rows
those windows read: ``[d*R*step, (d*R + R + k)*step)``, ``k =
ceil(vecsize / step)`` blocks of halo, padded with code 5.  Each shard
runs the single engine's chunk loop (``PredictionEngine._merged_blocks``)
on its own replica of the model on its device; the loops advance in turn,
one chunk of each shard at a time, so that shards on separate GPUs
overlap (kernel launches are asynchronous, and each runs on its tensor's
device).

The boundary hand-off: windows overlap, so shard ``d``'s final spill (the
``vecsize - step`` rows past its range) belongs to the head of shard
``d+1``'s range.  It is max-combined into shard ``d+1``'s raw float32
head rows, and on the scored route the combined rows are scored again
(argmax and max); the last shard's spill is the global tail.  The
overlap-max is associative and every window is in one shard, so the
result is bit for bit the single engine's.  With ``collective=True`` the
spill moves to the next shard's device (``.to()``) and is combined there
(``_boundary_merge``'s ``ppermute``); with ``collective=False`` the host
combines it.  Both give the same bytes.

Across processes (a default process group of more than one rank) the
global shard list is the ranks' local devices in rank order; each rank
runs its own shards, and the shards' packed tracks, heads and tails are
all-gathered as CPU tensors over a gloo group (as ``_fetch`` all-gathers
them), so every rank
holds the whole track and stitches it on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepgrp_tpu_torch.models.model import PAD_CODE, DeepGRPModel
from deepgrp_tpu_torch.parallel.mesh import Device, local_devices, world_size
from deepgrp_tpu_torch.predict.engine import (PredictionEngine,
                                              ScoredReadings, ScoredRows,
                                              ScoredTrack, window_starts)

# One shard's results: (track, head rows, tail rows).  The track is a
# ScoredRows of the shard's range (scored route) or its merged float32
# rows (``predict``); head and tail are raw float32 ``[overlap, C]``.
Parts = Tuple[object, torch.Tensor, torch.Tensor]


class _Shard:
    """One shard's chunk loop and what it keeps of it."""

    def __init__(self, engine: PredictionEngine, blocks, range_rows: int,
                 overlap: int, score: bool):
        device = engine.model.device
        n_classes = engine.model.config.n_classes
        self._blocks = blocks
        self._range_rows = range_rows
        self._overlap = overlap
        self._score = score
        self.track = (ScoredRows(range_rows, engine.compute_dtype, device)
                      if score else
                      torch.empty(range_rows, n_classes, device=device))
        self.head = torch.zeros(overlap, n_classes, device=device)
        self.tail = torch.zeros(overlap, n_classes, device=device)

    def step(self) -> bool:
        """Run one chunk; False when the loop has ended."""
        item = next(self._blocks, None)
        if item is None:
            return False
        lo, block = item
        if lo >= self._range_rows:
            # The final spill: the rows past the range.
            self.tail = block.clone()
        elif self._score:
            self.track.add(lo, block)
            if lo == 0:
                self.head = block[:self._overlap].clone()
        else:
            self.track[lo:lo + block.shape[0]] = block
            if lo == 0:
                self.head = self.track[:self._overlap]
        return True

    def parts(self) -> Parts:
        return self.track, self.head, self.tail


class ShardedPredictionEngine(ScoredReadings):
    """Windowed predictor sharded over devices (and processes), with the
    single engine's results and signatures (``predict``,
    ``scored_tracks`` and its readings, ``model``).

    ``devices`` are this process's shards (default: every visible GPU; a
    device may repeat).  ``collective`` picks where a shard boundary is
    combined in one process: on the next shard's device (True) or on the
    host (False).  Across processes the host combines it.
    """

    def __init__(self, model: DeepGRPModel,
                 devices: Optional[Sequence[Device]] = None,
                 batch_size: int = 256, step_size: int = 50,
                 compute_dtype: torch.dtype = torch.float32,
                 rnn_kernel: str = "auto", collective: bool = True):
        self.model = model
        self.devices = local_devices(devices)
        self._engines = [
            PredictionEngine(DeepGRPModel.from_params(model.config,
                                                      model.params(),
                                                      device),
                             batch_size=batch_size, step_size=step_size,
                             compute_dtype=compute_dtype,
                             rnn_kernel=rnn_kernel)
            for device in self.devices]
        first = self._engines[0]
        self.batch_size = first.batch_size
        self.step_size = first.step_size
        self.compute_dtype = compute_dtype
        self.collective = collective
        vecsize = model.config.vecsize
        self._k = -(-vecsize // self.step_size)
        self._overlap = max(vecsize - self.step_size, 0)
        self._gloo = None
        self._counts = [len(self.devices)]
        if world_size() > 1:
            # Results cross processes as CPU tensors over gloo, whatever
            # the default group's backend.
            self._gloo = dist.new_group(backend="gloo")
            counts: List[Optional[int]] = [None] * world_size()
            dist.all_gather_object(counts, len(self.devices),
                                   group=self._gloo)
            self._counts = [int(c) for c in counts]
        rank = dist.get_rank() if self._gloo is not None else 0
        self._first = sum(self._counts[:rank])
        self.n_shards = sum(self._counts)

    # -- the shards' chunk loops -------------------------------------------

    def _run(self, codes: np.ndarray, score: bool
             ) -> Optional[Tuple[List[Parts], int]]:
        """Run every local shard; returns the global shards' parts (on
        their devices, or on the host after a gather) and the rows a
        shard's range holds, or None when the sequence has no window."""
        config = self.model.config
        step, batch, k = self.step_size, self.batch_size, self._k
        n_windows = window_starts(codes.shape[0], config.vecsize,
                                  step).size
        if n_windows == 0:
            return None
        chunks = -(-n_windows // batch)
        chunks_per_shard = -(-chunks // self.n_shards)
        range_windows = chunks_per_shard * batch
        range_rows = range_windows * step
        rows = (self.n_shards * range_windows + k) * step
        padded = np.full(rows, PAD_CODE, np.int8)
        padded[:min(codes.shape[0], rows)] = codes[:rows]
        shards = []
        for i, engine in enumerate(self._engines):
            d = self._first + i
            lo = d * range_rows
            n_local = min(max(n_windows - d * range_windows, 0),
                          range_windows)
            _, blocks = engine._merged_blocks(
                padded[lo:lo + (range_windows + k) * step], n_local,
                chunks_per_shard)
            shards.append(_Shard(engine, blocks, range_rows, self._overlap,
                                 score))
        pending = shards
        while pending:  # one chunk of each shard in turn
            pending = [shard for shard in pending if shard.step()]
        parts = [shard.parts() for shard in shards]
        if self._gloo is not None:
            parts = self._all_gather(parts, range_rows, score)
        elif not self.collective:
            parts = [(ScoredRows(range_rows, self.compute_dtype, "cpu",
                                 track.buf.cpu()) if score else track.cpu(),
                      head.cpu(), tail.cpu())
                     for track, head, tail in parts]
        return parts, range_rows

    def _all_gather(self, parts: List[Parts], range_rows: int,
                    score: bool) -> List[Parts]:
        """Every rank's shards' parts, in global shard order, on the host:
        one ``all_gather`` of one byte row a shard over the gloo group."""
        n_classes = self.model.config.n_classes
        ov = self._overlap

        def as_bytes(tensor: torch.Tensor) -> torch.Tensor:
            return tensor.detach().cpu().contiguous().view(torch.uint8) \
                .reshape(-1)

        rows = [torch.cat([as_bytes(track.buf if score else track),
                           as_bytes(head), as_bytes(tail)])
                for track, head, tail in parts]
        width = rows[0].numel()
        most = max(self._counts)
        local = torch.zeros(most, width, dtype=torch.uint8)
        local[:len(rows)] = torch.stack(rows)
        gathered = [torch.empty_like(local) for _ in self._counts]
        dist.all_gather(gathered, local, group=self._gloo)
        head_bytes = 4 * ov * n_classes
        sizes = [width - 2 * head_bytes, head_bytes, head_bytes]

        def floats(raw: torch.Tensor) -> torch.Tensor:
            return raw.view(torch.float32).reshape(-1, n_classes)

        out = []
        for count, block in zip(self._counts, gathered):
            for row in block[:count]:
                # Copies, so that each part starts aligned for its dtype.
                raw, head, tail = (part.clone() for part in row.split(sizes))
                track = (ScoredRows(range_rows, self.compute_dtype, "cpu",
                                    raw) if score else floats(raw))
                out.append((track, floats(head), floats(tail)))
        return out

    # -- the two tracks ------------------------------------------------------

    def _seams(self, parts: List[Parts], range_rows: int
               ) -> List[Tuple[int, torch.Tensor]]:
        """What the shards' ranges leave out, as ``(first row, merged
        float32 rows)``: each boundary's rows combined (the head of the
        range after it with the spill of the range before it, on the
        head's device), then the global tail (the last shard's spill)."""
        if not self._overlap:
            return []
        seams = []
        for d in range(1, len(parts)):
            head = parts[d][1]
            seams.append((d * range_rows, torch.maximum(
                head, parts[d - 1][2].to(head.device))))
        return seams + [(len(parts) * range_rows, parts[-1][2])]

    def scored_tracks(self, codes: np.ndarray) -> Optional[ScoredTrack]:
        """The stitched scored track as a complete
        :class:`~deepgrp_tpu_torch.predict.engine.ScoredTrack` (the single
        engine's contract; ``scored_tracks``, ``parallel/predict.py:413``
        of the JAX package), or None when the sequence has no window.  It
        is assembled on the first shard's device (on the host across
        processes, and with ``collective=False``): each shard's range,
        then each boundary's combined rows scored again, then the global
        tail."""
        ran = self._run(codes, score=True)
        if ran is None:
            return None
        parts, range_rows = ran
        device = parts[0][0].buf.device
        track = ScoredRows(len(parts) * range_rows + self._overlap,
                           self.compute_dtype, device)
        for d, (rows, _, _) in enumerate(parts):
            track.place(d * range_rows, rows)
        for lo, rows in self._seams(parts, range_rows):
            track.add(lo, rows.to(device))
        return ScoredTrack(track, codes.shape[0])

    def routes_by_sparsity(self) -> bool:
        return True

    def device_route_ok(self) -> bool:
        """Whether the on-device MSS routes can take the track: False in a
        run of several processes, where the track is gathered on the host
        (the JAX package's multi-host guard, ``parallel/predict.py:427``)."""
        return self._gloo is None

    def predict(self, codes: np.ndarray,
                out_len: Optional[int] = None) -> np.ndarray:
        """Overlap-max merged class probabilities ``float32 [out_len,
        n_classes]``, bit for bit :meth:`PredictionEngine.predict`'s: each
        shard's range, then each boundary's combined rows, then the global
        tail, on the host."""
        out_len = codes.shape[0] if out_len is None else int(out_len)
        out = np.zeros((out_len, self.model.config.n_classes), np.float32)
        ran = self._run(codes, score=False)
        if ran is None:
            return out
        parts, range_rows = ran
        pieces = [(d * range_rows, track)
                  for d, (track, _, _) in enumerate(parts)]
        pieces += self._seams(parts, range_rows)
        for lo, rows in pieces:  # later pieces overwrite earlier ones
            take = min(rows.shape[0], out_len - lo)
            if take > 0:
                out[lo:lo + take] = rows[:take].cpu().numpy()
        return out
