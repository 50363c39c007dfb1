"""Hyperparameter / run configuration.

Counterpart of ``deepgrp_tpu/config.py`` (``Options``, itself a copy of the
reference DeepGRP's ``Options``, ``model.py:28-199``): the same attribute
names and defaults, dict-style access with the legacy ``gru_``-prefix
aliases, ``todict``/``fromdict`` and a TOML round trip.  TOML is read with
the standard library's ``tomllib`` and written with a minimal local
encoder.
"""

from __future__ import annotations

import os
import tomllib
from datetime import datetime, timezone
from typing import Any, Dict, List, TextIO, Union

Scalar = Union[float, int, str, bool]

# Attribute defaults, in reference order (model.py:83-127).
_DEFAULTS: Dict[str, Any] = {
    # General
    "project_root_dir": ".",
    "repeats_to_search": [1, 2, 3, 4],
    "vecsize": 150,
    "n_epochs": 200,
    "n_batches": 250,
    "early_stopping_th": 10,
    "batch_size": 256,
    "repeat_probability": 0.3,
    # Optimizer
    "optimizer": "RMSprop",
    "learning_rate": 0.001,
    "momentum": 0.9,
    "rho": 0.9,
    "epsilon": 1e-10,
    # Neural network
    "rnn": "GRU",
    "units": 32,
    "dropout": 0.25,
    "attention": False,
    # MSS
    "min_mss_len": 50,
    "xdrop_len": 50,
}


class Options:
    """Hyperparameters and run information of a model.

    Attributes follow the reference (``model.py:28-127``).  Extra keyword
    arguments become attributes (the reference does the same through
    ``__dict__.update``).
    """

    # pylint: disable=too-many-instance-attributes
    attention: bool
    batch_size: int
    dropout: float
    early_stopping_th: int
    epsilon: float
    learning_rate: float
    min_mss_len: int
    momentum: float
    n_batches: int
    n_epochs: int
    optimizer: str
    project_root_dir: str
    repeat_probability: float
    repeats_to_search: List[int]
    rho: float
    rnn: str
    units: int
    vecsize: int
    xdrop_len: int

    def __init__(self, **kwargs: Any) -> None:
        for key, value in _DEFAULTS.items():
            setattr(self, key, list(value) if isinstance(value, list)
                    else value)
        self.__dict__.update(kwargs)
        self._strip_legacy_keys()

    def _strip_legacy_keys(self) -> None:
        # Legacy `gru_units` / `gru_dropout` aliases (model.py:131-136).
        units = self.__dict__.pop("gru_units", None)
        dropout = self.__dict__.pop("gru_dropout", None)
        if units:
            self.units = units
        if dropout:
            self.dropout = dropout

    def __setitem__(self, key: str, item: Scalar) -> None:
        key = key.replace("gru_", "")  # legacy alias (model.py:138-140)
        self.__dict__[key] = item

    def __getitem__(self, key: str) -> Scalar:
        key = key.replace("gru_", "")
        return self.__dict__[key]

    def __str__(self) -> str:
        return str(self.__dict__)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Options):
            return NotImplemented
        return self.__dict__ == other.__dict__

    def todict(self) -> Dict[str, Any]:
        """Snapshot of all options as a plain dict (model.py:149-156)."""
        return self.__dict__.copy()

    def fromdict(self, dictionary: Dict[str, Any]) -> None:
        """Update the options in place from a dict (model.py:158-171)."""
        self.__dict__.update(dictionary)
        self._strip_legacy_keys()

    @classmethod
    def from_toml(cls, file: TextIO) -> "Options":
        """Options from a TOML file object (model.py:173-188)."""
        return cls(**tomllib.loads(file.read()))

    def to_toml(self, file: TextIO) -> None:
        """Write all options to a TOML file object (model.py:190-199)."""
        file.write(dumps_toml(self.__dict__))


def _toml_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(value, (list, tuple)):
        return "[ " + ", ".join(_toml_value(v) for v in value) + ",]"
    raise TypeError(f"Cannot encode {type(value)!r} as TOML")


def dumps_toml(data: Dict[str, Any]) -> str:
    """Minimal TOML encoder for flat dicts of scalars and lists."""
    return "".join(f"{key} = {_toml_value(val)}\n"
                   for key, val in data.items())


def create_logdir(options: Options) -> str:
    """Timestamped logdir ``<root>/tf_logs/run-YYYYmmddHHMMSS`` (the
    reference's scheme, ``model.py:12-25``)."""
    now = datetime.now(timezone.utc).strftime("%Y%m%d%H%M%S")
    return os.path.join(options.project_root_dir, "tf_logs", f"run-{now}")
