"""Command-line interface: ``python -m deepgrp_tpu_torch predict|train``.

Counterpart of the ``predict`` and ``train`` commands of
``deepgrp_tpu/cli.py`` (flag and output parity with the reference
``deepgrp`` CLI, ``__main__.py:86-356``): global flags ``--batch_size/-b
--step_size/-s --xdrop_length/-x --min_mss_length/-l --threads/-t -v``
with the same defaults.

``predict`` takes ``vecsize`` from the model file and writes one
``filename\\theader\\tstart\\tend\\tlabel`` row per segment with label > 0;
``--no_use_mss/-m`` labels each position with the argmax of the merged
probabilities' softmax instead of the MSS labelling.

``train PARAMS.toml TRAIN.npz VAL.npz BED`` trains on the one-hot ``fwd``
arrays of the two ``.npz`` files, labelled from the BED rows of the
chromosome named by each file name up to its first ``.``, and writes the
best weights as a ``.npz`` model that ``predict`` loads, or, for a
``--modelfile`` ending ``.h5``/``.hdf5``, as a Keras HDF5 model (needs
``h5py``, checked before any data loads).  The reference's
precedence quirk is kept: the CLI's option defaults (with ``-b -x -l``)
overwrite the TOML file's values, so ``vecsize``, ``units`` and the rest
fall back to their defaults, unless ``--honor-toml`` is given.

Several GPUs (``cli.py:80-90``, ``:158-184`` of the JAX package):
``predict --mesh auto`` (the default) shards the window stream over every
visible GPU when there is more than one
(:class:`~deepgrp_tpu_torch.parallel.predict.ShardedPredictionEngine`).
The PyTorch idiom is one process a GPU, so data-parallel ``train`` runs
over ranks: launch one process a GPU with ``torchrun`` (its environment
names the group) or with ``--coordinator HOST:PORT --num-processes N
--process-id R`` on each; ``train --mesh auto`` then trains
data-parallel when the batch size divides by the world size (else it
warns and each rank trains alone), and a multi-process ``predict`` shards
over the ranks' GPUs.  Each rank runs on ``cuda:$LOCAL_RANK`` (or its
rank modulo the GPU count); only rank 0 writes the BED, the model file
and the training logs.  A single process that sees several GPUs trains on
one.

``--threads/-t N`` (N > 0) bounds torch's host threads for the command
(``python -m deepgrp_tpu_torch`` also exports ``OMP_NUM_THREADS`` before
torch loads, ``__main__.py``) and the MSS workers; ``--xla`` is accepted
and does nothing, as in the JAX package; ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the command (CPU, and CUDA on the card)
under ``DIR``, the counterpart of the JAX package's ``jax.profiler`` trace.

``--device`` picks the device (default ``cuda``; with no GPU the command
fails rather than running on the CPU).  ``--precision bfloat16`` is the
fast mode of ``predict`` (float32 is the parity mode).  ``--rnn-kernel``
picks the route of ``predict`` and ``train``: ``fused`` (the fused
fwd+revcomp recurrence kernels on the codes), ``scan`` (one-hot windows
through the model's one-hot route; in training a plain loop differentiated
by autograd) or ``auto`` (fused, on every device).  ``train
--tensorboard`` (the default) writes TensorBoard event files beside
``metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
from typing import Iterator, List, Optional

_LOG = logging.getLogger("deepgrp_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    from deepgrp_tpu_torch import __version__

    parser = argparse.ArgumentParser(
        prog="deepgrp_tpu_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="DeepGRP (PyTorch/CUDA) - Prediction of repetitive "
        "elements")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    parser.add_argument("--batch_size", "-b", type=int, default=256,
                        help="Batch size to use for prediction")
    parser.add_argument("--step_size", "-s", type=int, default=50,
                        help="Window step size")
    parser.add_argument("--xdrop_length", "-x", type=int, default=50,
                        help="XDrop parameter for MSS algorithm, disabled "
                        "with values<0")
    parser.add_argument("--min_mss_length", "-l", type=int, default=50,
                        help="Minimal length of maximum scoring segments")
    parser.add_argument("--threads", "-t", type=int, default=1,
                        help="Number of host threads: torch's and the MSS "
                        "labelling's (all=0)")
    parser.add_argument("--xla", action="store_true",
                        help="Accepted for compatibility (always XLA)")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="Increase verbosity")
    parser.add_argument("--precision", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Inference compute dtype (float32 matches the "
                        "reference bit-for-bit; bfloat16 is faster)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device to run the model on")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="Write a torch.profiler Chrome trace of the "
                        "command into DIR (view with Perfetto or "
                        "chrome://tracing)")
    parser.add_argument("--rnn-kernel", choices=["auto", "scan", "fused"],
                        default="auto",
                        help="Recurrence route: 'fused' (fwd+revcomp "
                        "recurrence kernel on the codes), 'scan' (one-hot "
                        "windows through the model's one-hot route), "
                        "'auto' (fused)")

    parser.add_argument("--coordinator", type=str, default=None,
                        metavar="HOST:PORT",
                        help="Multi-process launch: the address of rank "
                        "0's rendezvous (with --num-processes and "
                        "--process-id; torchrun's environment serves "
                        "instead)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="Multi-process launch: the number of ranks")
    parser.add_argument("--process-id", type=int, default=None,
                        help="Multi-process launch: this process's rank")

    subparsers = parser.add_subparsers(help="sub-command help",
                                       dest="command")
    train = subparsers.add_parser(
        name="train",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Train a deepgrp model")
    train.add_argument("parameter", type=str,
                       help="toml file with parameters")
    train.add_argument("trainfile", type=str,
                       help="Training data: .npz with the one-hot 'fwd' "
                       "array [5, L]")
    train.add_argument("validfile", type=str,
                       help="Validation data, as trainfile")
    train.add_argument("bedfile", type=str,
                       help="Ground truth repeat annotation data.")
    train.add_argument("--logdir", type=str, default=".",
                       help="Directory for log / checkpoint files.")
    train.add_argument("--modelfile", type=str, default="model.npz",
                       help="Output path for the model file (.npz, or "
                       "Keras .h5/.hdf5).")
    train.add_argument("--honor-toml", action="store_true",
                       help="Let TOML values win over CLI defaults (the "
                       "reference overwrites TOML with defaults)")
    train.add_argument("--mesh", choices=["auto", "off"], default="auto",
                       help="Data-parallel training over the ranks of a "
                       "multi-process run (auto: when there is more than "
                       "one and the batch size divides)")
    train.add_argument("--tensorboard", action=argparse.BooleanOptionalAction,
                       default=True,
                       help="Write TensorBoard event files next to "
                       "metrics.jsonl (reference parity: always on, "
                       "training.py:40-45)")
    predict = subparsers.add_parser(
        name="predict",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="predict using a deepgrp model")
    predict.add_argument("model", type=str,
                         help="Model file (.npz of this package or Keras "
                         ".h5/.hdf5)")
    predict.add_argument("FASTA", nargs="+", type=str,
                         help="Fasta input files ('-' for stdin)")
    predict.add_argument("--output", type=str, default="-",
                         help="Output filename")
    predict.add_argument("--no_use_mss", "-m", action="store_true",
                         help="Disable maximum scoring segment algorithm")
    predict.add_argument("--mesh", choices=["auto", "off"], default="auto",
                         help="Shard the window stream over every visible "
                         "GPU (auto: when there is more than one, or over "
                         "the ranks of a multi-process run)")
    predict.add_argument("--device-mss", nargs="?", const="on",
                         choices=["auto", "on", "off"], default="auto",
                         help="Where the MSS runs: 'auto' streams the host "
                         "MSS behind the chunk loop (on several shards: "
                         "the device for a sparse track, the host for a "
                         "noisy one), 'on' runs it all on the device, "
                         "'off' on the host after the whole track")
    return parser


def setup_distributed(args: argparse.Namespace) -> bool:
    """Join a multi-process run when the launch flags or ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) name one (``cli.py:158-184`` of the JAX package).

    Returns True when this call started the process group (the caller
    ends it).  A malformed address raises ``ValueError``; every failure
    to join propagates, so a run never carries on as a single process.
    """
    from deepgrp_tpu_torch.parallel.mesh import initialize_distributed

    flags = (args.coordinator, args.num_processes, args.process_id)
    if all(flag is None for flag in flags):
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(flag is None for flag in flags):
        raise ValueError("--coordinator, --num-processes and --process-id "
                         "are given together")
    else:
        host, _, port = args.coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"--coordinator must be HOST:PORT, got "
                             f"{args.coordinator!r}")
        init_method = f"tcp://{host}:{port}"
        world, rank = args.num_processes, args.process_id
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    initialize_distributed(init_method, world, rank)
    _LOG.info("joined a process group: rank %d of %d", rank, world)
    return True


def run_device(name: str):
    """The device a command runs on: ``--device``, and in a multi-process
    run on CUDA this rank's GPU."""
    from deepgrp_tpu_torch.models.model import resolve_device
    from deepgrp_tpu_torch.parallel.mesh import rank_device, world_size

    device = resolve_device(name)
    if device.type == "cuda" and world_size() > 1:
        return rank_device()
    return device



def cmd_predict(args: argparse.Namespace) -> None:
    import torch

    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.data.fasta import read_multi_fasta
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.ops.segments import yield_segments
    from deepgrp_tpu_torch.parallel.mesh import is_first_rank, world_size
    from deepgrp_tpu_torch.parallel.predict import ShardedPredictionEngine
    from deepgrp_tpu_torch.predict.engine import PredictionEngine
    from deepgrp_tpu_torch.predict.postprocess import predict_sequence

    device = run_device(args.device)
    _LOG.debug("Loading model %s", args.model)
    config, params = load_model(args.model)
    model = DeepGRPModel.from_params(config, params, device)
    # vecsize comes from the model file (reference parity).
    options = Options(vecsize=config.vecsize, batch_size=args.batch_size,
                      min_mss_len=args.min_mss_length,
                      xdrop_len=args.xdrop_length)
    dtype = (torch.bfloat16 if args.precision == "bfloat16"
             else torch.float32)
    engine_args = dict(batch_size=options.batch_size,
                       step_size=args.step_size, compute_dtype=dtype,
                       rnn_kernel=args.rnn_kernel)
    n_gpus = torch.cuda.device_count() if device.type == "cuda" else 0
    if args.mesh == "auto" and (world_size() > 1 or n_gpus > 1):
        # One shard a rank in a multi-process run, else one a GPU.
        devices = [device] if world_size() > 1 else None
        engine = ShardedPredictionEngine(model, devices, **engine_args)
        _LOG.info("sharding windows over %d shards", engine.n_shards)
    else:
        engine = PredictionEngine(model, **engine_args)
    _LOG.info("Model loaded on %s", device)

    # Every rank computes (the sharded engine gathers the whole track);
    # rank 0 writes the BED.
    if not is_first_rank():
        outstream = open(os.devnull, "w")
    elif args.output == "-":
        outstream = sys.stdout
    else:
        outstream = open(args.output, "w")
    try:
        for filename in args.FASTA:
            _LOG.info("Processing %s", filename)
            filestream = sys.stdin if filename == "-" else open(filename)
            try:
                for header, dnasequence in read_multi_fasta(filestream):
                    startpos, codes = encode_codes_trimmed(dnasequence)
                    classes = predict_sequence(
                        engine, codes, options, threads=args.threads,
                        use_mss=not args.no_use_mss,
                        device_mss=args.device_mss)
                    for segment in yield_segments(classes, startpos):
                        if segment[2] > 0:
                            outstream.write("{}\t{}\t{}\t{}\t{}\n".format(
                                filename, header, *segment))
            finally:
                if filename != "-":
                    filestream.close()
    finally:
        if outstream is not sys.stdout:
            outstream.close()


def cmd_train(args: argparse.Namespace) -> None:
    import numpy as np

    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.data import preprocess
    import torch
    import torch.distributed as dist

    from deepgrp_tpu_torch.models import keras_io
    from deepgrp_tpu_torch.models.model import create_model
    from deepgrp_tpu_torch.parallel.mesh import is_first_rank, world_size
    from deepgrp_tpu_torch.train.training import training

    save_model = keras_io.save_model_npz
    if args.modelfile.endswith((".h5", ".hdf5")):
        keras_io.require_h5py()  # before a run whose model it cannot write
        save_model = keras_io.save_model_h5
    device = run_device(args.device)
    with open(args.parameter) as file:
        parameter = Options.from_toml(file)
    # Same trio of CLI-sourced options as the reference (__main__.py:245).
    options = Options(min_mss_len=args.min_mss_length,
                      batch_size=args.batch_size,
                      xdrop_len=args.xdrop_length)
    if not args.honor_toml:
        # Reference precedence: the full CLI Options dict (defaults + the
        # three CLI flags) overwrites the TOML values (__main__.py:309-311).
        parameter.fromdict(options.todict())
    else:
        parameter.min_mss_len = options.min_mss_len
        parameter.batch_size = options.batch_size
        parameter.xdrop_len = options.xdrop_len

    train_chr = os.path.basename(args.trainfile).split(".")[0]
    val_chr = os.path.basename(args.validfile).split(".")[0]
    if is_first_rank():
        os.makedirs(args.logdir, exist_ok=True)

    _LOG.info("Loading in all data necessary from %s, %s, %s",
              args.trainfile, args.validfile, args.bedfile)
    data = []
    for path, chrom in ((args.trainfile, train_chr),
                        (args.validfile, val_chr)):
        with np.load(path, allow_pickle=False) as arrays:
            fwd = arrays["fwd"]
        labels = preprocess.preprocess_y(args.bedfile, chrom, fwd.shape[1],
                                         parameter.repeats_to_search)
        data.append(preprocess.Data(*preprocess.drop_start_end_n(fwd,
                                                                 labels)))

    group = None
    world = world_size()
    if args.mesh == "auto" and world > 1:
        if parameter.batch_size % world:
            _LOG.warning("batch_size %d not divisible by %d ranks; each "
                         "rank trains alone", parameter.batch_size, world)
        else:
            group = dist.group.WORLD
            _LOG.info("data-parallel training over %d ranks", world)
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        _LOG.warning(
            "%d GPUs visible; this process trains on %s. For data-parallel "
            "training launch one process a GPU: torchrun --nproc-per-node "
            "N -m deepgrp_tpu_torch train ..., or --coordinator HOST:PORT "
            "--num-processes N --process-id R in each",
            torch.cuda.device_count(), device)

    model = create_model(parameter, device)
    _LOG.info("Training model on %s", device)
    best_params, _ = training((data[0], data[1]), parameter, model,
                              args.logdir, tensorboard=args.tensorboard,
                              rnn_kernel=args.rnn_kernel, group=group)
    if is_first_rank():
        _LOG.info("Saving model as %s", args.modelfile)
        save_model(args.modelfile, model.config, best_params)


@contextlib.contextmanager
def profile_trace(directory: Optional[str], command: str, device: str
                  ) -> Iterator[None]:
    """Trace the body with ``torch.profiler`` (CPU activities, and CUDA's
    for ``device`` ``cuda``) and write a Chrome trace,
    ``DIR/<command>.<pid>.pt.trace.json`` (``cli.py:237-246`` of the JAX
    package); no trace when ``directory`` is None."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(directory, f"{command}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _LOG.info("profiler trace written to %s", path)


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        sys.exit(2)
    levels = [logging.WARNING, logging.INFO, logging.DEBUG]
    logging.basicConfig()
    _LOG.setLevel(levels[min(len(levels) - 1, args.verbose)])
    import torch

    threads = torch.get_num_threads()
    if args.threads > 0:
        torch.set_num_threads(args.threads)
    _LOG.info("host threads: torch %d, OMP_NUM_THREADS %s",
              torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS"))
    started = False
    try:
        started = setup_distributed(args)
        with profile_trace(args.profile, args.command, args.device):
            if args.command == "train":
                cmd_train(args)
            else:
                cmd_predict(args)
    finally:
        torch.set_num_threads(threads)
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":  # pragma: no cover
    main()
