"""Parameters of the JAX package <-> parameters of this package.

The one place where the mapping between the two layouts is written.  The
JAX package keeps a nested pytree (``params["rnn"]["kernel"]``, ...); this
package keeps flat names (``"rnn.kernel"``, ...).  The arrays themselves are
the same Keras layouts, so the mapping is a renaming plus a conversion to
float32 tensors.  Takes numpy arrays (or anything ``np.asarray`` accepts);
imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

#: (JAX pytree path, flat name of this package)
_NAMES = (
    (("rnn", "kernel"), "rnn.kernel"),
    (("rnn", "recurrent"), "rnn.recurrent"),
    (("rnn", "bias"), "rnn.bias"),
    (("attention", "scale"), "attention.scale"),
    (("dense", "kernel"), "dense.kernel"),
    (("dense", "bias"), "dense.bias"),
)


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flat float32 CPU tensors from the JAX package's parameter pytree
    (``attention.scale`` only where the pytree has an attention entry)."""
    out: Dict[str, torch.Tensor] = {}
    for (group, name), flat in _NAMES:
        if group in params:
            out[flat] = torch.tensor(
                np.asarray(params[group][name], dtype=np.float32))
    return out


JaxParams = Dict[str, Dict[str, np.ndarray]]


def params_to_jax(params: Mapping[str, Any]) -> JaxParams:
    """The JAX package's nested pytree of float32 numpy arrays from flat
    parameters (tensors on any device, or arrays)."""
    out: JaxParams = {}
    for (group, name), flat in _NAMES:
        if flat in params:
            value = params[flat]
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            out.setdefault(group, {})[name] = np.asarray(value,
                                                         dtype=np.float32)
    return out
