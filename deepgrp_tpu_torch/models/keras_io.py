"""Model file IO: Keras HDF5 import and export, and the port's ``.npz``
format.

Counterpart of ``deepgrp_tpu/models/keras_io.py``.  ``load_keras_h5`` reads
models saved by the reference DeepGRP's ``model.save(...)`` (TF2 Keras
whole-model HDF5) into the port's flat parameters; the layouts map 1:1
because the recurrences reproduce Keras numerics.  ``save_model_h5`` writes
the same layout, so the reference (and the JAX package) load the port's
models.  ``h5py`` is imported only when an ``.h5`` file is read or written,
so machines without it load and write ``.npz`` files.

The ``.npz`` format holds one array per flat parameter name
(``rnn.kernel``, ...) plus a ``__config__`` entry: the :class:`ModelConfig`
as JSON bytes.  ``load_model_npz`` also reads the JAX package's model
files, whose arrays are keyed by ``/``-joined pytree paths (``rnn/kernel``,
``deepgrp_tpu/models/keras_io.py:31-44``) beside the same ``__config__``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from deepgrp_tpu_torch.models.model import COMPLEMENT_PERM, ModelConfig

Params = Dict[str, torch.Tensor]

_CONFIG_KEY = "__config__"


def save_model_npz(path: str, config: ModelConfig, params: Params) -> None:
    """Write a self-contained model file (parameters + config)."""
    arrays = {key: value.detach().cpu().numpy()
              for key, value in params.items()}
    arrays[_CONFIG_KEY] = np.frombuffer(
        json.dumps(config.todict()).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_model_npz(path: str) -> Tuple[ModelConfig, Params]:
    """Load a model file of this package or of the JAX package."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {key: data[key] for key in data.files}
    config = ModelConfig(**json.loads(arrays.pop(_CONFIG_KEY).tobytes()))
    # "rnn/kernel" (JAX package) and "rnn.kernel" (this package) name the
    # same array.
    params = {key.replace("/", "."): torch.from_numpy(
        np.ascontiguousarray(value, dtype=np.float32))
        for key, value in arrays.items()}
    _validate_shapes(config, params)
    return config, params


def _collect_weights(h5group) -> Dict[str, np.ndarray]:
    """Every dataset under a group, keyed by its full h5 path."""
    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if hasattr(obj, "shape") and obj.shape is not None:
            out[name] = np.asarray(obj)

    h5group.visititems(visit)
    return out


def load_keras_h5(path: str) -> Tuple[ModelConfig, Params]:
    """Import a reference Keras HDF5 model (GRU or LSTM, with or without
    attention)."""
    import h5py

    with h5py.File(path, "r") as f:
        raw_config = f.attrs.get("model_config")
        if raw_config is None:
            raise ValueError(f"{path}: not a Keras whole-model HDF5 file")
        if isinstance(raw_config, bytes):
            raw_config = raw_config.decode()
        model_config = json.loads(raw_config)
        weights = _collect_weights(f["model_weights"])

    layers = model_config.get("config", {}).get("layers", [])
    by_class = {layer["class_name"]: layer for layer in layers}
    rnn_type = "LSTM" if "LSTM" in by_class else "GRU"
    rnn_cfg = by_class[rnn_type]["config"]
    input_layer = by_class.get("InputLayer", {}).get("config", {})
    shape = input_layer.get("batch_input_shape") or input_layer.get(
        "batch_shape")

    def find(*fragments: str) -> np.ndarray:
        for name, value in weights.items():
            if all(fragment in name for fragment in fragments):
                return value
        raise KeyError(f"no weight matching {fragments} in {path}")

    rnn_layer = "BLSTM" if rnn_type == "LSTM" else "BGRU"
    arrays = {
        "rnn.kernel": find(rnn_layer, "/kernel"),
        "rnn.recurrent": find(rnn_layer, "recurrent_kernel"),
        "rnn.bias": find(rnn_layer, "bias"),
        "dense.kernel": find("FF", "kernel"),
        "dense.bias": find("FF", "bias"),
    }
    attention = "AdditiveAttention" in by_class
    if attention:
        arrays["attention.scale"] = find("additive_attention", "scale")
    config = ModelConfig(vecsize=int(shape[1]) if shape else 0,
                         units=int(rnn_cfg["units"]), rnn=rnn_type,
                         attention=attention,
                         n_classes=int(arrays["dense.bias"].shape[0]),
                         dropout=float(rnn_cfg.get("dropout", 0.0)))
    params = {key: torch.from_numpy(np.ascontiguousarray(value,
                                                         dtype=np.float32))
              for key, value in arrays.items()}
    _validate_shapes(config, params)
    return config, params


def _validate_shapes(config: ModelConfig, params: Params) -> None:
    want = config.param_shapes()
    if set(params) != set(want):
        raise ValueError(f"parameters {sorted(params)} do not match the "
                         f"model config's {sorted(want)}")
    for key, shape in want.items():
        if tuple(params[key].shape) != shape:
            raise ValueError(f"{key}: shape {tuple(params[key].shape)}, "
                             f"expected {shape}")


#: The Keras version whose whole-model HDF5 layout ``save_model_h5`` writes
#: (the ``tf_keras`` that writes the JAX package's files).
KERAS_VERSION = "2.21.0"


def _initializer(name: str, **config) -> dict:
    return {"module": "keras.initializers", "class_name": name,
            "config": {"seed": None, **config} if name != "Zeros" else {},
            "registered_name": None}


def _keras_layers(config: ModelConfig) -> List[dict]:
    """The reference architecture (``model.py:293-336``) as a Keras
    functional config, the layers in the order and with the names that
    ``tf_keras`` gives the JAX package's ``save_model_h5`` graph in a fresh
    session."""
    layers: List[dict] = []

    def add(class_name: str, layer: str, inbound: list, **fields) -> None:
        if class_name != "InputLayer":
            fields = {"name": layer, "trainable": True, "dtype": "float32",
                      **fields}
        layers.append({"class_name": class_name, "config": fields,
                       "name": layer, "inbound_nodes": inbound})

    def node(*refs) -> list:
        return [[layer, index, tensor, {}] for layer, index, tensor in refs]

    add("InputLayer", "input_1", [],
        batch_input_shape=[None, config.vecsize, config.input_dim],
        dtype="float32", sparse=False, ragged=False, name="input_1",
        optional=False)
    add("ReverseComplement", "reverse_complement",
        [node(("input_1", 0, 0))], complements=list(COMPLEMENT_PERM))
    lstm = config.rnn == "LSTM"
    rnn_name = "BLSTM" if lstm else "BGRU"
    rnn_fields = dict(
        return_sequences=True, return_state=config.use_attention,
        go_backwards=False, stateful=False, unroll=False, time_major=False,
        units=config.units, activation="tanh",
        recurrent_activation="sigmoid", use_bias=True,
        kernel_initializer=_initializer("GlorotUniform"),
        recurrent_initializer=_initializer("Orthogonal", gain=1.0),
        bias_initializer=_initializer("Zeros"))
    if lstm:
        rnn_fields["unit_forget_bias"] = True
    rnn_fields.update(
        kernel_regularizer=None, recurrent_regularizer=None,
        bias_regularizer=None, activity_regularizer=None,
        kernel_constraint=None, recurrent_constraint=None,
        bias_constraint=None, dropout=config.dropout, recurrent_dropout=0.0,
        implementation=2)
    if not lstm:
        rnn_fields["reset_after"] = True
    add("LSTM" if lstm else "GRU", rnn_name,
        [node(("input_1", 0, 0)), node(("reverse_complement", 0, 0))],
        **rnn_fields)
    if config.use_attention:
        add("Average", "average", [node((rnn_name, 0, 1), (rnn_name, 1, 1))])
        add("Reshape", "reshape", [node(("average", 0, 0))],
            target_shape=[1, config.units])
        add("Average", "average_1",
            [node((rnn_name, 0, 0), (rnn_name, 1, 0))])
        add("AdditiveAttention", "additive_attention",
            [node(("reshape", 0, 0), ("average_1", 0, 0))], dropout=0.0,
            use_scale=True)
        add("Flatten", "flatten", [node(("additive_attention", 0, 0))],
            data_format="channels_last")
        add("RepeatVector", "repeat_vector", [node(("flatten", 0, 0))],
            n=config.vecsize)
        add("Concatenate", "concatenate",
            [node(("repeat_vector", 0, 0), ("average_1", 0, 0))], axis=-1)
        features = "concatenate"
    else:
        add("Average", "average", [node((rnn_name, 0, 0), (rnn_name, 1, 0))])
        features = "average"
    add("Dense", "FF", [node((features, 0, 0))], units=config.n_classes,
        activation="linear", use_bias=True,
        kernel_initializer=_initializer("GlorotUniform"),
        bias_initializer=_initializer("Zeros"),
        kernel_regularizer=None, bias_regularizer=None,
        activity_regularizer=None, kernel_constraint=None,
        bias_constraint=None)
    add("Softmax", "softmax", [node(("FF", 0, 0))], axis=2)
    return layers


def require_h5py():
    """The ``h5py`` module; ``ImportError`` naming it where it is
    missing."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError("writing a Keras .h5 model needs h5py, which is "
                          "not installed; write a .npz model instead"
                          ) from err
    return h5py


def save_model_h5(path: str, config: ModelConfig, params: Params) -> None:
    """Write a Keras 2 whole-model HDF5 file (``save_model_h5``,
    ``keras_io.py:138-223`` of the JAX package).

    The reference loads models with ``tf.keras.models.load_model(path,
    custom_objects={"ReverseComplement": ...})`` and takes ``vecsize`` from
    the input shape (its ``__main__.py:264-270``); the file holds the
    reference architecture as a functional ``model_config`` (JSON), the
    ``keras_version`` and ``backend``, and under ``model_weights`` one group
    a layer with its ``weight_names`` and datasets named as ``tf_keras``
    names them (``BGRU/BGRU/gru_cell/kernel:0``, ...).  Written with
    ``h5py`` (:func:`require_h5py`); ``load_keras_h5`` reads it back bit
    for bit.
    """
    h5py = require_h5py()
    _validate_shapes(config, params)
    arrays = {key: np.ascontiguousarray(value.detach().cpu().numpy(),
                                        dtype=np.float32)
              for key, value in params.items()}
    cell = "lstm_cell" if config.rnn == "LSTM" else "gru_cell"
    rnn_name = "BLSTM" if config.rnn == "LSTM" else "BGRU"
    weights = {
        rnn_name: [(f"{rnn_name}/{cell}/kernel:0", arrays["rnn.kernel"]),
                   (f"{rnn_name}/{cell}/recurrent_kernel:0",
                    arrays["rnn.recurrent"]),
                   (f"{rnn_name}/{cell}/bias:0", arrays["rnn.bias"])],
        "FF": [("FF/kernel:0", arrays["dense.kernel"]),
               ("FF/bias:0", arrays["dense.bias"])],
    }
    if config.use_attention:
        weights["additive_attention"] = [
            ("additive_attention/scale:0", arrays["attention.scale"])]
    layers = _keras_layers(config)
    model_config = {"class_name": "Functional", "config": {
        "name": "model", "trainable": True, "layers": layers,
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["softmax", 0, 0]]}}
    names = [layer["name"] for layer in layers]
    with h5py.File(path, "w") as f:
        f.attrs["keras_version"] = KERAS_VERSION
        f.attrs["backend"] = "tensorflow"
        f.attrs["model_config"] = json.dumps(model_config).encode("utf8")
        group = f.create_group("model_weights")
        text = h5py.string_dtype()
        group.attrs.create("layer_names", names, dtype=text)
        group.attrs["backend"] = b"tensorflow"
        group.attrs["keras_version"] = KERAS_VERSION.encode("utf8")
        for name in sorted(names) + ["top_level_model_weights"]:
            layer = group.create_group(name)
            pairs = weights.get(name, [])
            layer.attrs.create("weight_names",
                               [weight for weight, _ in pairs], dtype=text)
            for weight, value in pairs:
                layer.create_dataset(weight, data=value)


def load_model(path: str) -> Tuple[ModelConfig, Params]:
    """Load a Keras model (``.h5``/``.hdf5``) or a ``.npz`` model of this
    package or the JAX package; any other name is sniffed for the HDF5
    magic (``keras_io.py:226-236`` of the JAX package).  Parameters come
    back on the CPU."""
    if path.endswith((".h5", ".hdf5")):
        return load_keras_h5(path)
    if path.endswith(".npz"):
        return load_model_npz(path)
    with open(path, "rb") as file:
        magic = file.read(8)
    if magic.startswith(b"\x89HDF"):
        return load_keras_h5(path)
    return load_model_npz(path)
