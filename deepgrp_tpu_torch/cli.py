"""Command-line interface: ``python -m deepgrp_tpu_torch predict``.

Counterpart of the ``predict`` command of ``deepgrp_tpu/cli.py`` (flag and
output parity with the reference ``deepgrp`` CLI, ``__main__.py:86-356``):
global flags ``--batch_size/-b --step_size/-s --xdrop_length/-x
--min_mss_length/-l --threads/-t -v`` with the same defaults, ``vecsize``
taken from the model file, and one ``filename\\theader\\tstart\\tend\\tlabel``
row per segment with label > 0.

``--device`` picks the device (default ``cuda``; with no GPU the command
fails rather than running on the CPU).  ``--precision`` accepts only
``float32`` for now.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

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
                        help="Number of host threads of the MSS labelling "
                        "(all=0)")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="Increase verbosity")
    parser.add_argument("--precision", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Inference compute dtype (only float32 is "
                        "ported)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device to run the model on")

    subparsers = parser.add_subparsers(help="sub-command help",
                                       dest="command")
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
    return parser


def cmd_predict(args: argparse.Namespace) -> None:
    from deepgrp_tpu_torch.config import Options
    from deepgrp_tpu_torch.data.fasta import read_multi_fasta
    from deepgrp_tpu_torch.models.keras_io import load_model
    from deepgrp_tpu_torch.models.model import DeepGRPModel, resolve_device
    from deepgrp_tpu_torch.ops.encoding import encode_codes_trimmed
    from deepgrp_tpu_torch.ops.segments import yield_segments
    from deepgrp_tpu_torch.predict.engine import PredictionEngine
    from deepgrp_tpu_torch.predict.postprocess import predict_sequence

    if args.precision != "float32":
        raise NotImplementedError(
            f"--precision {args.precision} is not yet ported; float32 is "
            "the only mode of deepgrp_tpu_torch so far")
    device = resolve_device(args.device)
    _LOG.debug("Loading model %s", args.model)
    config, params = load_model(args.model)
    model = DeepGRPModel.from_params(config, params, device)
    # vecsize comes from the model file (reference parity).
    options = Options(vecsize=config.vecsize, batch_size=args.batch_size,
                      min_mss_len=args.min_mss_length,
                      xdrop_len=args.xdrop_length)
    engine = PredictionEngine(model, batch_size=options.batch_size,
                              step_size=args.step_size)
    _LOG.info("Model loaded on %s", device)

    outstream = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for filename in args.FASTA:
            _LOG.info("Processing %s", filename)
            filestream = sys.stdin if filename == "-" else open(filename)
            try:
                for header, dnasequence in read_multi_fasta(filestream):
                    startpos, codes = encode_codes_trimmed(dnasequence)
                    classes = predict_sequence(engine, codes, options,
                                               threads=args.threads)
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


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        sys.exit(2)
    levels = [logging.WARNING, logging.INFO, logging.DEBUG]
    logging.basicConfig()
    _LOG.setLevel(levels[min(len(levels) - 1, args.verbose)])
    cmd_predict(args)


if __name__ == "__main__":  # pragma: no cover
    main()
