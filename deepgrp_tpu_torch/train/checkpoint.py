"""Parameter checkpointing.

A copy of ``deepgrp_tpu/train/checkpoint.py``, file format included, so
checkpoints interoperate with the JAX package in both directions (the
port's flat parameters go through
:func:`deepgrp_tpu_torch.models.convert.params_to_jax` on the way in and
``params_from_jax`` on the way out).

The reference stores per-epoch best-only weight checkpoints in
``logdir/{epoch:02d}`` and restores the latest via TF's CheckpointManager
(the reference DeepGRP's ``training.py:53-59``, ``prediction.py:68-86``).
Here a checkpoint is a single ``.npz`` holding the flattened parameter
pytree (keys are ``/``-joined paths), written atomically; ``CheckpointManager``
keeps the best-only, per-epoch naming scheme and a ``checkpoint`` pointer
file naming the latest, so restore-latest works the same way.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import numpy as np

Params = Dict[str, Any]

_CKPT_RE = re.compile(r"^(\d+)\.npz$")
_POINTER = "checkpoint"


def _flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Params:
    tree: Params = {}
    for path, value in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_params(path: str, params: Params) -> None:
    """Atomically write a parameter pytree to ``path`` (.npz)."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as file:
            np.savez(file, **_flatten(params))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_params(path: str) -> Params:
    """Load a parameter pytree written by :func:`save_params`."""
    with np.load(path) as data:
        return _unflatten({key: data[key] for key in data.files})


class CheckpointManager:
    """Per-epoch best-only checkpoints plus a latest pointer."""

    def __init__(self, logdir: os.PathLike):
        self.logdir = os.fspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)

    def path_for(self, epoch: int) -> str:
        return os.path.join(self.logdir, f"{epoch:02d}.npz")

    def save(self, epoch: int, params: Params) -> str:
        path = self.path_for(epoch)
        save_params(path, params)
        pointer = os.path.join(self.logdir, _POINTER)
        with open(pointer, "w") as file:
            file.write(os.path.basename(path) + "\n")
        return path

    def latest_path(self) -> Optional[str]:
        pointer = os.path.join(self.logdir, _POINTER)
        if os.path.exists(pointer):
            with open(pointer) as file:
                name = file.read().strip()
            candidate = os.path.join(self.logdir, name)
            if os.path.exists(candidate):
                return candidate
        epochs = []
        if os.path.isdir(self.logdir):
            for name in os.listdir(self.logdir):
                match = _CKPT_RE.match(name)
                if match:
                    epochs.append((int(match.group(1)), name))
        if not epochs:
            return None
        return os.path.join(self.logdir, max(epochs)[1])


def latest_checkpoint_params(logdir: os.PathLike) -> Params:
    """Restore the latest checkpoint in ``logdir`` (raises if none)."""
    path = CheckpointManager(logdir).latest_path()
    if path is None:
        raise FileNotFoundError(f"no checkpoint found in {logdir!r}")
    return load_params(path)
