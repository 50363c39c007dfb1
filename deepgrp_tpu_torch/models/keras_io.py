"""Model file IO: reference Keras HDF5 import and the port's ``.npz`` format.

Counterpart of ``deepgrp_tpu/models/keras_io.py``.  ``load_keras_h5`` reads
models saved by the reference DeepGRP's ``model.save(...)`` (TF2 Keras
whole-model HDF5) into the port's flat parameters; the layouts map 1:1
because the recurrences reproduce Keras numerics.  ``h5py`` is imported only
when an ``.h5`` file is read, so machines without it load ``.npz`` files.

The ``.npz`` format holds one array per flat parameter name
(``rnn.kernel``, ...) plus a ``__config__`` entry: the :class:`ModelConfig`
as JSON bytes.  ``load_model_npz`` also reads the JAX package's model
files, whose arrays are keyed by ``/``-joined pytree paths (``rnn/kernel``,
``deepgrp_tpu/models/keras_io.py:31-44``) beside the same ``__config__``.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from deepgrp_tpu_torch.models.model import ModelConfig

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


def load_model(path: str) -> Tuple[ModelConfig, Params]:
    """Load a Keras model (``.h5``/``.hdf5``) or a ``.npz`` model of this
    package (any other name), picked by suffix.  Parameters come back on
    the CPU."""
    if path.endswith((".h5", ".hdf5")):
        return load_keras_h5(path)
    return load_model_npz(path)
