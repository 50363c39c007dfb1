"""On-device sliding-window prediction engine.

Counterpart of ``deepgrp_tpu/predict/engine.py`` (``PredictionEngine``:
the scored track, ``scored_tracks`` and its readings, and the
merged-probability track, ``predict``).  The compact code sequence goes to
the device once; for each chunk of ``batch_size`` windows the engine

  * gathers the code windows (``unfold`` of the padded sequence, the torch
    form of ``chunk_windows``),
  * runs the model on one of two routes (:func:`resolve_rnn_kernel`): the
    fused route (the fused fwd+revcomp recurrence kernel on the codes, then
    the attention + dense head and softmax), or the scan route (the code
    windows become one-hot rows, pad code 5 an all-zero row, and go through
    ``DeepGRPModel.apply``: one recurrence over the doubled batch),
  * zeroes the windows past the last real one (the final chunk is padded
    to the batch size, so the kernel always sees the same shape),
  * overlap-max merges the chunk (ops/overlap_max.py) and carries the
    ``vecsize - step`` rows that reach into the next chunk as a spill, and
  * scores each position of the finished block: int8 argmax class and
    float32 max probability, kept on the device (``predict`` keeps the
    block's rows instead).

The two score tracks live in one byte buffer (:class:`ScoredRows`), 5 B/bp
in float32; a :class:`ScoredTrack` copies it to the host a slice of
``SLICE_CHUNKS`` chunks at a time while later chunks compute, so the host
MSS can run behind the chunk loop, or keeps it on the device for the
device MSS routes.  The bfloat16 fast mode (``compute_dtype``) keeps the
max probability as 2 bytes, so its tracks are 3 B/bp; that rounding is the
mode's contract (``engine.py:197-212``): the probabilities are nominally
bfloat16, and every consumer sees the rounded track.  ``predict``'s merged
rows (20 B/bp at 5 classes) come back in one copy at the end.

Window enumeration parity with the reference (``prediction.py:31``): window
starts are ``range(0, L - vecsize, step_size)``; the window starting exactly
at ``L - vecsize`` is excluded, and ``L <= vecsize`` gives zero windows.

Divergence from the reference, kept from the JAX package: every window is
placed at its true offset ``i * step_size`` (the reference misplaces the
final partial batch, ``prediction.py:105``).
"""

from __future__ import annotations

import itertools
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from deepgrp_tpu_torch.models.model import (PAD_CODE, DeepGRPModel, one_hot,
                                            resolve_rnn_kernel)
from deepgrp_tpu_torch.ops import mss, mss_device
from deepgrp_tpu_torch.ops.overlap_max import overlap_max_merge
from deepgrp_tpu_torch.train.sampler import codes_from_onehot_rows

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
#: Chunks in a slice of the scored track (``SLICE_CHUNKS``, ``engine.py:167``
#: of the JAX package): at ``-b 1024 -s 50`` a slice is 204,800 positions,
#: 1 MB in float32.
SLICE_CHUNKS = 4


def window_starts(seq_len: int, vecsize: int, step_size: int) -> np.ndarray:
    """Reference-parity window start positions (prediction.py:31)."""
    return np.arange(0, max(seq_len - vecsize, 0), step_size, dtype=np.int64)


def mss_score_transform(classes: np.ndarray, maxp: np.ndarray,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """The reference MSS score transform (prediction.py:51-57), float32.

    ``t = log(p/(1-p))`` with ``p = min(max_prob + 1e-6, 0.99)``;
    background positions score ``-10*t``, repeat positions ``+t``.  The
    reference's operations in its order, in place where it can (two
    temporaries), into ``out`` if given: the streaming route transforms a
    slice beside the chunk loop's thread and should hold the interpreter
    little.
    """
    mins = maxp + np.float32(1e-6)
    np.minimum(mins, np.float32(0.99), out=mins)
    odds = 1 - mins
    np.divide(mins, odds, out=mins)
    t_scores = np.log(mins, out=mins)
    scores = np.multiply(t_scores, -10, out=odds if out is None else out)
    np.copyto(scores, t_scores, where=classes > 0)
    return scores


class ScoredReadings:
    """The scored track's readings, for an engine with ``scored_tracks``
    (the single and the sharded engine)."""

    def scored_tracks(self, codes: np.ndarray) -> Optional["ScoredTrack"]:
        raise NotImplementedError

    def routes_by_sparsity(self) -> bool:
        """Whether ``predict_sequence``'s ``auto`` route chooses by the
        track's positive runs (the sharded engine), rather than streaming
        the host MSS behind the chunk loop (the single engine)."""
        return False

    def predict_scored(self, codes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-position ``(classes int8 [L], max_prob float32 [L])``.

        ``codes`` is the sequence's int8 code track (A=0..T=3, N=4).
        Positions no window covers come back as class 0 with probability 0
        (the reference merges into a zero buffer).
        """
        track = self.scored_tracks(codes)
        if track is None:
            return (np.zeros(codes.shape[0], np.int8),
                    np.zeros(codes.shape[0], np.float32))
        return track.host_scored()

    def predict_scored_device(self, codes: np.ndarray):
        """``(classes int8, max_prob float32, rows)`` kept on the track's
        device (``predict_scored_device``, ``engine.py:744`` of the JAX
        package): the first ``rows`` positions are the sequence's (the
        track may be longer, or shorter: uncovered positions), or
        ``(None, None, 0)`` when there is no window."""
        track = self.scored_tracks(codes)
        if track is None:
            return None, None, 0
        classes, maxp = track.device()
        return classes, maxp, min(track.out_len, classes.shape[0])

    def predict_mss_scores(self, codes: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-position ``(classes int8 [L], MSS scores float32 [L])``
        (``predict_mss_scores``, ``engine.py:837`` of the JAX package): the
        reference transform of :meth:`predict_scored`'s track, positions no
        window covers at the zero-probability score."""
        track = self.scored_tracks(codes)
        if track is None:
            return (np.zeros(codes.shape[0], np.int8),
                    np.full(codes.shape[0], zero_fill_score(), np.float32))
        return track.host_mss_scores()


class PredictionEngine(ScoredReadings):
    """Windowed predictor for one model, on the model's device.

    ``compute_dtype`` is float32 (the parity mode) or bfloat16 (the fast
    mode); ``rnn_kernel`` picks the route (:func:`resolve_rnn_kernel`).
    """

    def __init__(self, model: DeepGRPModel, batch_size: int = 256,
                 step_size: int = 50,
                 compute_dtype: torch.dtype = torch.float32,
                 rnn_kernel: str = "auto"):
        self.model = model
        self.step_size = int(step_size)
        if self.step_size <= 0:
            raise ValueError(f"step_size must be positive, got {step_size}")
        # A chunk's spill must fit inside the next chunk's block:
        # batch*step >= vecsize - step, i.e. batch >= K - 1.  Chunks are
        # masked anyway, so raising a degenerate batch size is free.
        k = -(-model.config.vecsize // self.step_size)
        self.batch_size = max(int(batch_size), k)
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.fused = resolve_rnn_kernel(rnn_kernel)

    def _probs(self, chunk: torch.Tensor) -> torch.Tensor:
        """Float32 class probabilities of one chunk of code windows."""
        if self.fused:
            probs = self.model.forward_probs_from_codes(chunk,
                                                        self.compute_dtype)
        else:
            probs = self.model.apply(one_hot(chunk, self.compute_dtype))
        return probs.to(torch.float32)

    def _merged_blocks(self, codes: np.ndarray, n_windows: int,
                       n_chunks: Optional[int] = None
                       ) -> Tuple[int, Iterator[Tuple[int, torch.Tensor]]]:
        """The chunk loop that both tracks share (``scan_chunk_range``,
        ``engine.py:74-197``).

        Returns ``(rows, blocks)``: ``blocks`` yields ``(first row,
        merged float32 rows [n, n_classes])`` on the device, in order of
        rows and each final (the last one is the final chunk's spill),
        covering rows ``0 .. rows - 1``.  A block is a view that the next
        chunk reuses: read it before asking for the next.

        ``n_chunks`` (default: as many as the windows need) runs a fixed
        number of chunks, windows past the ``n_windows``-th masked: a
        shard of the sharded engine runs its whole range, so its final
        spill is the rows past its range.  ``codes`` are then the shard's
        rows, the halo included.
        """
        config = self.model.config
        vecsize, step, batch = config.vecsize, self.step_size, self.batch_size
        k = -(-vecsize // step)
        if n_chunks is None:
            n_chunks = -(-n_windows // batch)
        block_rows = batch * step
        span = (batch - 1) * step + vecsize
        spill_rows = max(span - block_rows, 0)  # == vecsize - step if > 0
        rows = (n_chunks * batch + k) * step
        padded = np.full(rows, PAD_CODE, np.int8)
        padded[:min(codes.shape[0], rows)] = codes[:rows]
        device = self.model.device
        # [n_chunks*batch + ..., vecsize] view: window w starts at w*step.
        windows = torch.from_numpy(padded).to(device).unfold(0, vecsize, step)

        def blocks() -> Iterator[Tuple[int, torch.Tensor]]:
            spill = torch.zeros(spill_rows, config.n_classes, device=device)
            for c in range(n_chunks):
                chunk = windows[c * batch:(c + 1) * batch].contiguous()
                probs = self._probs(chunk)
                n_real = n_windows - c * batch
                if n_real < batch:
                    probs[max(n_real, 0):] = 0.0
                merged = overlap_max_merge(probs, step, max(span, block_rows))
                block = merged[:block_rows]
                if spill_rows:
                    torch.maximum(block[:spill_rows], spill,
                                  out=block[:spill_rows])
                    spill = merged[block_rows:]
                yield c * block_rows, block
            if spill_rows:
                # The final spill's rows: no further chunk reaches them.
                yield n_chunks * block_rows, spill

        return n_chunks * block_rows + spill_rows, blocks()

    def predict(self, codes: np.ndarray,
                out_len: Optional[int] = None) -> np.ndarray:
        """Overlap-max merged class probabilities, ``float32 [out_len,
        n_classes]`` (``PredictionEngine.predict``, ``engine.py:643-679``).

        ``codes`` is the sequence's int8 code track ``[L]``; ``out_len``
        (default ``L``) sizes the output, as ``results_shape`` in the
        reference's ``prediction.py:90``.  Rows no window covers are zeros.
        The merged rows stay on the device and come back in one copy
        (20 B/bp at 5 classes).  In the bfloat16 fast mode the track is
        float32 holding the bfloat16 probabilities, as the JAX engine's
        unscored track is.
        """
        out_len = codes.shape[0] if out_len is None else int(out_len)
        n_classes = self.model.config.n_classes
        n_windows = window_starts(codes.shape[0], self.model.config.vecsize,
                                  self.step_size).size
        out = np.zeros((out_len, n_classes), np.float32)
        if n_windows == 0:
            return out
        rows, blocks = self._merged_blocks(codes, n_windows)
        merged = torch.empty(rows, n_classes, device=self.model.device)
        for lo, block in blocks:
            merged[lo:lo + block.shape[0]] = block
        take = min(out_len, rows)
        out[:take] = merged[:take].cpu().numpy()
        return out

    def scored_tracks(self, codes: np.ndarray) -> Optional["ScoredTrack"]:
        """The scored track of ``codes`` (the int8 code track ``[L]``) as a
        :class:`ScoredTrack` whose chunk loop runs as its reader asks for
        slices (``scored_tracks``, ``engine.py:534-550`` of the JAX
        package), or None when the sequence has no window (the callers
        keep the reference's all-zero-buffer quirk)."""
        out_len = int(codes.shape[0])
        n_windows = window_starts(out_len, self.model.config.vecsize,
                                  self.step_size).size
        if n_windows == 0:
            return None
        total, blocks = self._merged_blocks(codes, n_windows)
        return ScoredTrack(ScoredRows(total, self.compute_dtype,
                                      self.model.device), out_len, blocks)

    def device_route_ok(self) -> bool:
        """Whether the on-device MSS routes can take this engine's track:
        always, since the track lies on the model's device."""
        return True


def predict(model: DeepGRPModel, params: Optional[Dict[str, torch.Tensor]],
            onehot: np.ndarray, results_shape: Tuple[int, int],
            step_size: int, batch_size: int = 256) -> np.ndarray:
    """The reference's one-shot ``predict`` (``prediction.py:89-111``;
    ``predict``, ``engine.py:1063`` of the JAX package): the overlap-max
    merged probabilities ``float32 [results_shape]`` of the one-hot
    sequence ``onehot [5, L]`` (all-zero columns become the pad code),
    through :meth:`PredictionEngine.predict` on the model's device.
    ``params`` (flat names, as ``model.params()``) replace the model's
    weights for this call; ``None`` keeps them."""
    if params is not None:
        model = DeepGRPModel.from_params(model.config, params, model.device)
    if results_shape[1] != model.config.n_classes:
        raise ValueError(f"results_shape {tuple(results_shape)}: the model "
                         f"has {model.config.n_classes} classes")
    engine = PredictionEngine(model, batch_size=batch_size,
                              step_size=step_size)
    return engine.predict(codes_from_onehot_rows(np.asarray(onehot)),
                          out_len=results_shape[0])


class ScoredRows:
    """Per-position scores of merged rows, kept where the rows are.

    Both score tracks of ``rows`` positions live in one byte buffer,
    ``buf`` (maxp in ``dtype``, then the int8 classes), so they come back
    to the host (or go over a collective) as one tensor.  Storing maxp in
    a bfloat16 track rounds it to nearest even, on the card and on the
    CPU alike: that rounding is the fast mode's contract.
    """

    def __init__(self, rows: int, dtype: torch.dtype,
                 device: Union[str, torch.device],
                 buf: Optional[torch.Tensor] = None):
        self.rows = rows
        self.maxp_size = torch.finfo(dtype).bits // 8
        self.buf = (torch.empty((self.maxp_size + 1) * rows,
                                dtype=torch.uint8, device=device)
                    if buf is None else buf)
        self._maxp = self.buf[:self.maxp_size * rows].view(dtype)
        self._classes = self.buf[self.maxp_size * rows:].view(torch.int8)

    def add(self, lo: int, block: torch.Tensor) -> None:
        """Score merged float32 rows ``block [n, n_classes]`` as positions
        ``lo .. lo + n - 1``: argmax class and max probability."""
        hi = lo + block.shape[0]
        self._classes[lo:hi] = block.argmax(dim=1)
        self._maxp[lo:hi] = block.amax(dim=1)

    def place(self, lo: int, other: "ScoredRows") -> None:
        """Copy ``other``'s positions in as positions ``lo ..``."""
        hi = lo + other.rows
        self._classes[lo:hi] = other._classes.to(self.buf.device)
        self._maxp[lo:hi] = other._maxp.to(self.buf.device)

    def byte_ranges(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """The spans of ``buf`` that hold positions ``lo .. hi - 1``."""
        split = self.maxp_size * self.rows
        return [(self.maxp_size * lo, self.maxp_size * hi),
                (split + lo, split + hi)]

    def device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(classes int8 [rows], max_prob float32 [rows])`` where the
        rows are (a bfloat16 track widened exactly)."""
        return self._classes, self._maxp.to(torch.float32)

    def host(self, buf: np.ndarray, lo: int,
             hi: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(classes int8, max_prob float32)`` of positions ``lo .. hi -
        1``, read from ``buf``, a host copy of ``self.buf``."""
        (m_lo, m_hi), (c_lo, c_hi) = self.byte_ranges(lo, hi)
        if self.maxp_size == 2:
            # numpy has no bfloat16: widen the 16 bits into the top half of
            # a float32 (exact).
            u16 = buf[m_lo:m_hi].view(np.uint16)
            maxp = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            maxp = buf[m_lo:m_hi].view(np.float32)
        return buf[c_lo:c_hi].view(np.int8), maxp


def zero_fill_score() -> np.float32:
    """The MSS score of a position no window covers: zero probability,
    class 0, which the reference's transform scores positive
    (``prediction.py:90`` zeros, ``:51-57``)."""
    return mss_score_transform(np.zeros(1, np.int8),
                               np.zeros(1, np.float32))[0]


class ScoredTrack:
    """One sequence's scored track as the chunk loop writes it, and its
    readings for the MSS routes (``ScoredTrack``, ``engine.py:294-437`` of
    the JAX package).

    The rows come in slices: every ``SLICE_CHUNKS`` chunks, and after the
    final spill, the rows scored since the last slice form one.  On a CUDA
    device the track records an event on the compute stream, and a side
    stream waits for it, copies the slice's bytes of ``rows.buf`` into
    pinned host memory (``non_blocking``) and records a second event; a
    reader synchronises on that event alone, so the chunk loop goes on.  On
    the CPU the track already lies on the host.  The chunk loop runs as a
    host reader asks for slices (:meth:`enqueue`), each slice's copy queued
    as soon as its chunks are scored; a reading on the device
    (:meth:`device`) runs the loop to its end and copies nothing.
    ``blocks`` are the chunk loop's ``(first row, merged rows)``
    (:meth:`PredictionEngine._merged_blocks`); without them ``rows`` is
    complete and forms one slice.
    """

    def __init__(self, rows: ScoredRows, out_len: int,
                 blocks: Iterable[Tuple[int, torch.Tensor]] = ()):
        self.rows = rows
        self.out_len = int(out_len)
        #: Row ranges ``(lo, hi)`` of the slices scored so far.
        self.slices: List[Tuple[int, int]] = []
        # Slice index -> the event that ends its copy (None on the CPU).
        self._copied: Dict[int, Optional[torch.cuda.Event]] = {}
        self._device = rows.buf.device
        # On a CUDA device: pinned host memory and the side stream, made at
        # the first copy.
        self._host: Optional[torch.Tensor] = (
            rows.buf if self._device.type == "cpu" else None)
        self._stream: Optional[torch.cuda.Stream] = None
        self._chunks = self._run(iter(blocks))

    def _run(self, blocks: Iterator[Tuple[int, torch.Tensor]]
             ) -> Iterator[int]:
        lo = 0
        for count, (first, block) in enumerate(blocks, 1):
            self.rows.add(first, block)
            if count % SLICE_CHUNKS == 0:
                self.slices.append((lo, first + block.shape[0]))
                lo = self.slices[-1][1]
                yield len(self.slices) - 1
        if lo < self.rows.rows:
            self.slices.append((lo, self.rows.rows))
            yield len(self.slices) - 1

    def enqueue(self) -> Iterator[int]:
        """Runs the chunk loop; yields the index (into :attr:`slices`) of
        every slice, in order, as soon as its copy to the host is queued
        (first those that an earlier reading ran the loop through)."""
        for i in itertools.chain(range(len(self.slices)), self._chunks):
            self._copy(i)
            yield i

    def finish(self) -> None:
        """Runs the chunk loop to its end (copying nothing more)."""
        for _ in self._chunks:
            pass

    def _copy(self, i: int) -> None:
        """Queues slice ``i``'s copy to the host, unless it was."""
        if i in self._copied:
            return
        if self._device.type == "cpu":
            self._copied[i] = None
            return
        if self._stream is None:
            self._host = torch.empty(self.rows.buf.shape, dtype=torch.uint8,
                                     pin_memory=True)
            self._stream = torch.cuda.Stream(self._device)
            # The side stream reads the buffer: the allocator must not hand
            # it out again before those reads end.
            self.rows.buf.record_stream(self._stream)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._device))
        self._stream.wait_event(ready)
        with torch.cuda.stream(self._stream):
            for a, b in self.rows.byte_ranges(*self.slices[i]):
                self._host[a:b].copy_(self.rows.buf[a:b], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[i] = done

    def wait(self, i: int) -> None:
        """Waits for slice ``i``'s copy (issuing it if it was not), and
        for nothing else."""
        self._copy(i)
        event = self._copied[i]
        if event is not None:
            event.synchronize()

    def host_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(classes int8, max_prob float32)`` of positions ``lo .. hi -
        1`` from the host copy; their slices must have been waited for."""
        return self.rows.host(self._host.numpy(), lo, hi)

    def device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(classes int8 [rows], max_prob float32 [rows])`` on the
        track's device (the rows may run past ``out_len``, and may stop
        short of it: uncovered positions)."""
        self.finish()
        return self.rows.device()

    def count_runs(self) -> int:
        """Positive runs of the track's MSS scores within ``out_len`` (one
        scalar read): the sparsity routing's signal."""
        return mss_device.scored_run_count(*self.device(), self.out_len)

    def _host_covered(self) -> Tuple[int, np.ndarray, np.ndarray]:
        for _ in self.enqueue():
            pass
        for i in range(len(self.slices)):
            self.wait(i)
        covered = min(self.rows.rows, self.out_len)
        return (covered, *self.host_rows(0, covered))

    def host_scored(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(classes int8 [out_len], max_prob float32 [out_len])`` on the
        host; uncovered positions are class 0 with probability 0."""
        covered, classes_h, maxp_h = self._host_covered()
        classes = np.zeros(self.out_len, np.int8)
        maxp = np.zeros(self.out_len, np.float32)
        classes[:covered] = classes_h
        maxp[:covered] = maxp_h
        return classes, maxp

    def host_mss_scores(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(classes int8 [out_len], MSS scores float32 [out_len])`` on the
        host: the reference transform (:func:`mss_score_transform`), the
        zero-probability score past the covered rows."""
        covered, classes_h, maxp_h = self._host_covered()
        classes = np.zeros(self.out_len, np.int8)
        scores = np.full(self.out_len, zero_fill_score(), np.float32)
        classes[:covered] = classes_h
        scores[:covered] = mss_score_transform(classes_h, maxp_h)
        return classes, scores

    def host_mss_classes(self, options, nof_labels: int,
                         threads: int = 0) -> np.ndarray:
        """The host MSS labels ``int32 [out_len]``, streamed behind the
        chunk loop (``_mss_classes_streaming``, ``engine.py:860-977`` of
        the JAX package).

        The calling thread runs the chunk loop and queues each slice's copy;
        a reader thread takes the slices in order as their copies land,
        transforms their rows into scores and feeds them to
        :class:`~deepgrp_tpu_torch.ops.mss.SplitScanner`; each block the
        scanner closes is labelled in a worker pool.  The loop thread does
        nothing else, since it must keep the card fed.  Pool and reader are
        made for the call; the pool has ``threads`` workers (0:
        :func:`~deepgrp_tpu_torch.ops.mss.default_threads`).  The last
        block, past the last split, is labelled after the loop with the
        multithreaded search.  The output is that of the whole-array
        search, for any thread count.  With ``xdrop_len <= 0`` no split
        exists and the whole array is searched at the end.
        """
        if options.xdrop_len <= 0:
            classes, scores = self.host_mss_scores()
            return mss.find_mss_classes(
                scores.astype(np.float64), classes.astype(np.int64),
                nof_labels, options.min_mss_len, options.xdrop_len, threads)
        out_len = self.out_len
        classes = np.zeros(out_len, np.int8)
        scores = np.full(out_len, zero_fill_score(), np.float32)
        out = np.empty(out_len, np.int32)
        scanner = mss.SplitScanner(
            mss.mss_thresholds(options.min_mss_len, options.xdrop_len)[1])
        workers = threads if threads > 0 else mss.default_threads(out_len)
        args = (nof_labels, options.min_mss_len, options.xdrop_len)
        landing: "queue.Queue[Optional[int]]" = queue.Queue()

        def read(pool: ThreadPoolExecutor) -> Tuple[int, list]:
            futures, block_start = [], 0
            while (i := landing.get()) is not None:
                lo, hi = self.slices[i]
                hi = min(hi, out_len)
                if hi <= lo:
                    continue
                self.wait(i)
                classes_s, maxp_s = self.host_rows(lo, hi)
                classes[lo:hi] = classes_s
                mss_score_transform(classes_s, maxp_s, out=scores[lo:hi])
                for split in scanner.feed(scores, hi):
                    futures.append(pool.submit(
                        mss.streaming_mss_block_classes, scores, classes,
                        out, block_start, split, *args))
                    block_start = split
            return block_start, futures

        with ThreadPoolExecutor(workers) as pool, \
                ThreadPoolExecutor(1) as reader:
            reading = reader.submit(read, pool)
            try:
                for i in self.enqueue():
                    landing.put(i)
            finally:
                landing.put(None)
            block_start, futures = reading.result()
            out[block_start:] = mss.find_mss_classes(
                scores[block_start:], classes[block_start:], *args,
                threads=threads)
            for future in futures:
                future.result()
        return out
