"""Every public reference entry point that the JAX package holds
(``tests/test_api_surface.py``) has its counterpart in the port, with the
same parameters; the thin wrappers the port adds for it return the JAX
function's values on the same inputs (exactly for ``mss_find_all``,
``get_max``, ``get_segments`` and the encoding)."""

import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.models import model as jax_model  # noqa: E402
from deepgrp_tpu.ops import encoding as jax_encoding  # noqa: E402
from deepgrp_tpu.ops import mss as jax_mss  # noqa: E402
from deepgrp_tpu.ops import overlap_max as jax_overlap_max  # noqa: E402
from deepgrp_tpu.ops import segments as jax_segments  # noqa: E402
from deepgrp_tpu.predict import engine as jax_engine  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.models.convert import params_from_jax  # noqa: E402


def _has_params(fn, *names):
    sig = inspect.signature(fn)
    for name in names:
        assert name in sig.parameters, (fn, name, sig)


def test_mss_module():  # reference: deepgrp.mss (pymss.pyx)
    from deepgrp_tpu_torch.ops.mss import find_mss_labels, mss_find_all

    _has_params(find_mss_labels, "scores", "labels", "nof_labels",
                "min_mss_len", "xdrop_len")
    _has_params(mss_find_all, "scores", "min_score", "xdrop")


def test_sequence_module():  # reference: deepgrp.sequence (sequence.pyx)
    from deepgrp_tpu_torch.ops.encoding import one_hot_encode_dna_sequence
    from deepgrp_tpu_torch.ops.overlap_max import get_max
    from deepgrp_tpu_torch.ops.segments import get_segments, yield_segments

    _has_params(one_hot_encode_dna_sequence, "sequence")
    _has_params(get_max, "output", "inputs", "stride")
    _has_params(get_segments, "classes", "startpos")
    _has_params(yield_segments, "classes", "start_offset")


def test_preprocessing_module():  # reference: deepgrp.preprocessing
    from deepgrp_tpu_torch.data.preprocess import (Data, drop_start_end_n,
                                                   preprocess_y)

    _has_params(preprocess_y, "filename", "chromosom", "length",
                "repeats_to_search")
    _has_params(drop_start_end_n, "fwd", "array")
    assert set(Data._fields) == {"fwd", "truelbl"}


def test_model_module():  # reference: deepgrp.model
    from deepgrp_tpu_torch.config import Options, create_logdir
    from deepgrp_tpu_torch.models.model import (create_model,
                                                reverse_complement)

    _has_params(create_model, "options")
    assert callable(create_logdir)
    options = Options()
    assert options.vecsize == 150 and options.units == 32
    assert options.batch_size == 256 and options.n_epochs == 200
    assert callable(reverse_complement)


def test_training_module():  # reference: deepgrp.training
    from deepgrp_tpu_torch.train.sampler import BatchSampler, calc_indices
    from deepgrp_tpu_torch.train.training import training

    _has_params(training, "data", "options", "model", "logdir")
    assert callable(calc_indices)
    assert callable(BatchSampler)


def test_prediction_module():  # reference: deepgrp.prediction
    from deepgrp_tpu_torch.ops.segments import filter_segments
    from deepgrp_tpu_torch.predict.engine import predict
    from deepgrp_tpu_torch.predict.metrics import (
        calculate_metrics, calculate_multiclass_matthews_cc,
        confusion_matrix)
    from deepgrp_tpu_torch.predict.postprocess import (
        apply_mss, predict_complete, setup_prediction_from_options_checkpoint,
        softmax)

    _has_params(predict, "model", "params", "onehot", "results_shape",
                "step_size")
    _has_params(apply_mss, "probs", "options")
    _has_params(predict_complete, "step_size", "options", "logdir", "data",
                "use_mss")
    _has_params(setup_prediction_from_options_checkpoint, "options", "logdir")
    for fn in (calculate_metrics, confusion_matrix,
               calculate_multiclass_matthews_cc, softmax, filter_segments):
        assert callable(fn)


def test_optimization_module():  # reference: deepgrp.optimization
    from deepgrp_tpu_torch.hpo.optimization import (build_and_optimize,
                                                    run_a_trial)
    from deepgrp_tpu_torch.hpo.space import reference_search_space

    _has_params(build_and_optimize, "train_data", "val_data", "step_size",
                "options", "options_dict")
    _has_params(run_a_trial, "space", "objective", "project_root_dir",
                "max_evals")
    assert callable(reference_search_space)


def test_scripts():  # reference: deepgrp._scripts + console entry points
    import tomllib

    from deepgrp_tpu_torch.data.parse_rm import main as parse_rm_main
    from deepgrp_tpu_torch.data.preprocess_sequence import \
        main as preprocess_main

    assert callable(parse_rm_main)
    assert callable(preprocess_main)
    with open("pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["deepgrp_tpu_torch"] == "deepgrp_tpu_torch.cli:main"
    assert scripts["deepgrp_tpu_torch_preprocess_sequence"] == (
        "deepgrp_tpu_torch.data.preprocess_sequence:main")
    assert scripts["deepgrp_tpu_torch_parse_rm"] == (
        "deepgrp_tpu_torch.data.parse_rm:main")
    for name in ("deepgrp_tpu", "preprocess_sequence", "parse_rm"):
        assert scripts[name].startswith("deepgrp_tpu.")


def test_cli_module():  # reference: deepgrp.__main__
    from deepgrp_tpu_torch.cli import build_parser, main

    assert callable(main)
    parser = build_parser()
    args = parser.parse_args(
        ["-b", "128", "-s", "25", "-x", "10", "-l", "20", "-t", "2",
         "--xla", "predict", "model.npz", "in.fa", "--no_use_mss"])
    assert args.batch_size == 128 and args.step_size == 25
    assert args.xdrop_length == 10 and args.min_mss_length == 20
    assert args.threads == 2 and args.xla and args.no_use_mss


def test_new_capabilities_exported():
    # Capabilities beyond the reference that the JAX package promises.
    from deepgrp_tpu_torch.hpo.vmapped import run_parallel_trials
    from deepgrp_tpu_torch.ops.mss_device import (find_mss_labels_device,
                                                  mss_classes_device,
                                                  mss_classes_from_scored,
                                                  mss_find_all_device)
    from deepgrp_tpu_torch.ops.overlap_max import overlap_max_merge
    from deepgrp_tpu_torch.parallel import (ShardedPredictionEngine,
                                            dp_train_step,
                                            initialize_distributed,
                                            launch_local, local_devices,
                                            make_mesh)
    from deepgrp_tpu_torch.predict.engine import PredictionEngine

    for fn in (find_mss_labels_device, mss_classes_device,
               mss_classes_from_scored, mss_find_all_device,
               overlap_max_merge, ShardedPredictionEngine, dp_train_step,
               initialize_distributed, local_devices, PredictionEngine,
               run_parallel_trials, launch_local, make_mesh):
        assert callable(fn)
    import deepgrp_tpu_torch.parallel as parallel

    assert sorted(parallel.__all__) == [
        "ShardedPredictionEngine", "dp_train_step", "initialize_distributed",
        "launch_local", "local_devices", "make_mesh"]
    # The JAX package's name for the device list (parallel/mesh.py:15).
    assert make_mesh is local_devices
    with pytest.raises(AttributeError):
        parallel.make_dp_mesh  # noqa: B018


# -- values against the JAX package ------------------------------------------


@pytest.mark.parametrize("seed,n,threads", [(0, 5000, 1), (1, 300000, 4),
                                            (2, 1, 0), (3, 0, 0)])
@pytest.mark.parametrize("xdrop", [-1.0, 40.0])
def test_mss_find_all_equals_jax(seed, n, threads, xdrop):
    from deepgrp_tpu_torch.ops.mss import mss_find_all

    rng = np.random.default_rng(seed)
    scores = np.where(rng.random(n) < 0.3, rng.random(n) * 4.0,
                      -rng.random(n) * 6.0)
    got = mss_find_all(scores, 12.5, xdrop, threads=threads)
    want = jax_mss.mss_find_all(scores, 12.5, xdrop, threads=threads)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sequence", [
    "", "NNNN", "acgtNNACGTRYnn", "NNNACGTTGCAN",
    "".join(np.random.default_rng(4).choice(list("ACGTNacgtn"), 2000))])
def test_one_hot_encode_dna_sequence_equals_jax(sequence):
    from deepgrp_tpu_torch.ops.encoding import one_hot_encode_dna_sequence

    start, onehot = one_hot_encode_dna_sequence(sequence)
    want_start, want = jax_encoding.one_hot_encode_dna_sequence(sequence)
    assert start == want_start
    assert onehot.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(onehot, want)


@pytest.mark.parametrize("batch,dim0,stride", [(7, 20, 5), (3, 10, 10),
                                               (4, 6, 9), (0, 5, 3)])
def test_get_max_equals_jax(batch, dim0, stride):
    from deepgrp_tpu_torch.ops.overlap_max import get_max

    rng = np.random.default_rng(batch + dim0)
    inputs = rng.random((batch, dim0, 5)).astype(np.float32)
    rows = max((batch - 1) * stride + dim0, 1)
    start = rng.random((rows, 5)).astype(np.float32) * 0.5
    got, want = start.copy(), start.copy()
    assert get_max(got, inputs, stride) is got
    jax_overlap_max.get_max(want, inputs, stride)
    np.testing.assert_array_equal(got, want)


def test_get_max_checks_shapes_as_jax():
    from deepgrp_tpu_torch.ops.overlap_max import get_max

    for output, inputs in ((np.zeros((10, 5), np.float32),
                            np.zeros((2, 4), np.float32)),
                           (np.zeros((10, 4), np.float32),
                            np.zeros((2, 4, 5), np.float32)),
                           (np.zeros((5, 5), np.float32),
                            np.zeros((2, 4, 5), np.float32))):
        for fn in (get_max, jax_overlap_max.get_max):
            with pytest.raises(ValueError):
                fn(output, inputs, 3)


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 1), (2, 200), (3, 2)])
def test_get_segments_equals_jax(seed, n):
    from deepgrp_tpu_torch.ops.segments import get_segments

    classes = np.random.default_rng(seed).choice(
        [0, 0, 0, 1, 2], n).repeat(3)
    start = 0
    while start < classes.size - 1:
        got = get_segments(classes, start)
        assert got == jax_segments.get_segments(classes, start)
        start = got[1]


@pytest.mark.parametrize("rnn_type,attention", [("GRU", True),
                                                ("LSTM", False)])
def test_create_model_equals_jax(rnn_type, attention):
    from deepgrp_tpu_torch.models.model import create_model

    options = Options(vecsize=40, units=6, rnn=rnn_type,
                      attention=attention, repeats_to_search=[1, 2, 3])
    model = create_model(options, device="cpu")
    want = jax_model.create_model(JaxOptions(**options.todict()))
    assert model.config.todict() == want.config.__dict__
    assert model.device == torch.device("cpu")
    jax_params = jax_model.init_params(jax.random.PRNGKey(0), want.config)
    assert {k: tuple(v.shape) for k, v in model.params().items()} == {
        k: tuple(v.shape) for k, v in params_from_jax(jax_params).items()}


def test_create_model_defaults_to_the_card():
    from deepgrp_tpu_torch.models.model import create_model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(Options())


@pytest.mark.parametrize("length,step,batch", [(700, 50, 4), (61, 7, 3),
                                               (30, 10, 8)])
def test_engine_predict_equals_jax(length, step, batch):
    from deepgrp_tpu_torch.models.model import DeepGRPModel, ModelConfig
    from deepgrp_tpu_torch.predict.engine import predict

    config = ModelConfig(vecsize=30, units=8, attention=True, dropout=0.0)
    jax_cfg = jax_model.ModelConfig(**config.todict())
    params = jax_model.init_params(jax.random.PRNGKey(1), jax_cfg)
    rng = np.random.default_rng(length)
    onehot = np.eye(5, dtype=np.int8)[rng.integers(0, 5, length)].T.copy()
    onehot[:, :3] = 0  # hard-masked columns
    shape = (length + 5, 5)
    want = jax_engine.predict(jax_model.DeepGRPModel(jax_cfg), params, onehot,
                              shape, step, batch_size=batch)
    zeros = DeepGRPModel(config, "cpu")
    got = predict(zeros, params_from_jax(params), onehot, shape, step,
                  batch_size=batch)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    loaded = DeepGRPModel.from_params(config, params_from_jax(params), "cpu")
    np.testing.assert_array_equal(
        predict(loaded, None, onehot, shape, step, batch_size=batch), got)
    with pytest.raises(ValueError, match="classes"):
        predict(loaded, None, onehot, (length, 4), step)
