"""The DeepGRP classifier: weight-shared fwd/revcomp RNN with attention.

Counterpart of ``deepgrp_tpu/models/model.py``: the fused paths
(``forward_probs_from_codes`` for inference,
``forward_logits_from_codes_train`` for training), drawn below, and the
one-hot route (``forward`` / ``forward_logits`` / ``DeepGRPModel.apply``
over one-hot windows ``x [B, T, 5]``: one recurrence over the doubled
batch ``[x, reverse_complement(x)]``, then the branch average and the same
head; ``forward_logits(..., train=True)`` is its training form)::

    codes [B, T]
      ├─ fused fwd + reverse-complement recurrence with branch averaging
      │    (models/cuda_rnn.py: the CUDA kernel, or its plain version on CPU;
      │    training adds per-gate input dropout masks and a backward kernel)
      │    -> avg [B, T, u], hidden = (h_fwd[T-1] + h_rev[T-1]) / 2 [B, u]
      ├─ if attention and GRU:
      │     att   = AdditiveAttention(hidden, avg)         -> [B, u]
      │     feats = concat(repeat(att, T), avg)            -> [B, T, 2u]
      │  else: feats = avg
      ├─ Dense(n_classes) logits (layer "FF")
      └─ softmax over classes (inference; training takes the logits)

Keras ``AdditiveAttention`` (use_scale=True): ``scores[b, t] = sum_d
scale[d] * tanh(q[b, d] + k[b, t, d])``; softmax over t; the output is the
weighted sum of the values.

Parameters are a flat ``dict[str, Tensor]`` (the model's ``state_dict``):
``rnn.kernel``, ``rnn.recurrent``, ``rnn.bias``, ``attention.scale`` (with
attention), ``dense.kernel``, ``dense.bias``, in the Keras layouts of the
JAX package (``models/rnn.py``).

bfloat16 is the fast mode of inference: the recurrence runs at the TPU's
``DEFAULT`` precision (:mod:`deepgrp_tpu_torch.models.rnn`) and the head
in bfloat16.
"""

from __future__ import annotations

import functools
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from deepgrp_tpu_torch.models import cuda_rnn, rnn

Params = Mapping[str, torch.Tensor]
RnnApply = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

# DNA complement channel permutation: A<->T, C<->G, N<->N (encoding A=0
# C=1 G=2 T=3 N=4).
COMPLEMENT_PERM = (3, 2, 1, 0, 4)
# The code of a position that selects no input row (all-zero one-hot row).
PAD_CODE = 5


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (fields and defaults as in the JAX
    package's ``ModelConfig``)."""

    vecsize: int = 150
    units: int = 32
    rnn: str = "GRU"
    attention: bool = False
    n_classes: int = 5
    dropout: float = 0.25
    input_dim: int = 5

    @classmethod
    def from_options(cls, options: Any) -> "ModelConfig":
        """The architecture of a run's :class:`~deepgrp_tpu_torch.config.
        Options` (``n_classes`` = repeats searched + background)."""
        return cls(vecsize=int(options.vecsize), units=int(options.units),
                   rnn=str(options.rnn), attention=bool(options.attention),
                   n_classes=len(options.repeats_to_search) + 1,
                   dropout=float(options.dropout))

    @property
    def use_attention(self) -> bool:
        # Attention only takes effect with GRU (reference model.py:308).
        return self.attention and self.rnn != "LSTM"

    @property
    def feature_dim(self) -> int:
        return 2 * self.units if self.use_attention else self.units

    @property
    def gates(self) -> int:
        return 4 if self.rnn == "LSTM" else 3

    def param_shapes(self) -> Dict[str, tuple]:
        """Shape of every parameter, by ``state_dict`` key."""
        width = self.gates * self.units
        shapes = {
            "rnn.kernel": (self.input_dim, width),
            "rnn.recurrent": (self.units, width),
            "rnn.bias": (width,) if self.rnn == "LSTM" else (2, width),
        }
        if self.use_attention:
            shapes["attention.scale"] = (self.units,)
        shapes["dense.kernel"] = (self.feature_dim, self.n_classes)
        shapes["dense.bias"] = (self.n_classes,)
        return shapes

    def todict(self) -> dict:
        return asdict(self)


def require_full_f32_matmul() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN and check that it is off.

    The float32 head (forward and backward) must run in full float32, as
    the JAX head runs at ``"highest"`` precision; TF32 keeps about three
    decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("could not disable TF32 for CUDA matmuls and "
                           "cuDNN")


def init_params(config: ModelConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Keras-default initial parameters (``model.py:87-108``), flat float32
    CPU tensors drawn from ``generator`` (a CPU generator): the cell's
    initialisers, glorot-uniform attention scale and dense kernel, zero
    dense bias."""
    init = rnn.lstm_init if config.rnn == "LSTM" else rnn.gru_init
    cell = init(config.input_dim, config.units, generator)
    params = {f"rnn.{key}": value for key, value in cell.items()}
    if config.use_attention:
        params["attention.scale"] = rnn.glorot_uniform(
            (config.units, 1), generator).reshape(config.units)
    params["dense.kernel"] = rnn.glorot_uniform(
        (config.feature_dim, config.n_classes), generator)
    params["dense.bias"] = torch.zeros(config.n_classes)
    return params


def additive_attention(scale: torch.Tensor, query: torch.Tensor,
                       keyvalue: torch.Tensor) -> torch.Tensor:
    """Keras AdditiveAttention with one query vector per batch row.

    Args:
        scale: ``[u]`` learned scale.
        query: ``[B, u]``.
        keyvalue: ``[B, T, u]`` (keys are the values).

    Returns:
        ``[B, u]`` attention output.
    """
    scores = torch.einsum("u,btu->bt", scale,
                          torch.tanh(query[:, None, :] + keyvalue))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bt,btu->bu", weights, keyvalue)


def head_logits(params: Params, avg: torch.Tensor, hidden: torch.Tensor,
                config: ModelConfig) -> torch.Tensor:
    """Attention + dense head over the branch-averaged recurrence outputs:
    ``[B, T, n_classes]`` logits (``_head_logits``, ``model.py:175-188``;
    shared by the inference and the training path).  Runs in ``avg``'s
    dtype; the head's parameters must be in it too."""
    if avg.is_cuda:
        require_full_f32_matmul()
    if config.use_attention:
        att = additive_attention(params["attention.scale"], hidden, avg)
        feats = torch.cat([att[:, None, :].expand_as(avg), avg], dim=-1)
    else:
        feats = avg
    return feats @ params["dense.kernel"] + params["dense.bias"]


def _rnn_params(params: Params) -> Dict[str, torch.Tensor]:
    return {"kernel": params["rnn.kernel"],
            "recurrent": params["rnn.recurrent"],
            "bias": params["rnn.bias"]}


def _cast(params: Params, dtype: torch.dtype) -> Params:
    """``params`` in ``dtype`` (the same mapping for float32)."""
    if dtype == torch.float32:
        return params
    return {key: value.to(dtype) for key, value in params.items()}


def reverse_complement(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sequence axis and complement the channel axis of one-hot
    ``x [..., T, 5]`` (``model.py:78-84``): ``COMPLEMENT_PERM`` reverses
    A, C, G, T and keeps N, taken here as slices, so no index tensor is
    copied from the host (a CUDA graph cannot capture that copy)."""
    rev = x.flip(-2)
    return torch.cat([rev[..., :4].flip(-1), rev[..., 4:]], dim=-1)


def forward_logits(params: Params, x: torch.Tensor, config: ModelConfig,
                   rnn_apply: Optional[RnnApply] = None,
                   masks: Optional[torch.Tensor] = None,
                   train: bool = False) -> torch.Tensor:
    """One-hot windows ``x [B, T, 5]`` -> logits ``[B, T, n_classes]``
    (``model.py:147-172``).

    ``train=True`` is the training form (the JAX package's scan route under
    ``jax.grad``): the recurrence is :func:`~deepgrp_tpu_torch.models.rnn.
    gru_train_apply` / ``lstm_train_apply`` (the plain loop, differentiated
    by autograd), with Keras input dropout from ``masks [g, 2B, 5]`` over
    the doubled batch (rows ``0..B-1`` forward, ``B..2B-1`` reverse
    complement), or none for ``masks=None`` (the JAX ``deterministic``
    form).  ``x`` is then float32, and ``rnn_apply`` is not given.

    Otherwise it is the inference form, without masks.  ``x`` is float32,
    or bfloat16 for the fast mode: then every parameter
    is cast to bfloat16 (as the JAX engine casts them,
    ``engine.py:102-103``) and the head runs in bfloat16.  ``rnn_apply``
    overrides the recurrence (signature of
    :func:`~deepgrp_tpu_torch.models.rnn.gru_apply`).

    By default the GRU runs through the ``dg_gru_seq`` kernel's wrapper
    (:func:`~deepgrp_tpu_torch.models.cuda_rnn.gru_apply`; its plain
    version on the CPU) and the LSTM through plain torch
    (:func:`~deepgrp_tpu_torch.models.rnn.lstm_apply`).  The JAX package's
    one-hot route runs XLA's ``lax.scan`` for both cells
    (``model.py:158-160``).  The function is the same, but on the card no
    plain version of a kernel runs, so the GRU goes through the
    hand-written kernel; no TPU kernel computes the LSTM over a float
    input, so it has none.
    """
    batch = x.shape[0]
    if x.is_cuda:
        require_full_f32_matmul()  # the recurrence's dots too
    if train:
        if rnn_apply is not None:
            raise ValueError("train=True takes its own recurrence")
        train_apply = (rnn.lstm_train_apply if config.rnn == "LSTM"
                       else rnn.gru_train_apply)
        rnn_apply = functools.partial(train_apply, masks=masks)
    elif masks is not None:
        raise ValueError("dropout masks are a training input (train=True)")
    elif rnn_apply is None:
        rnn_apply = (rnn.lstm_apply if config.rnn == "LSTM"
                     else cuda_rnn.gru_apply)
    params = _cast(params, x.dtype)
    both = torch.cat([x, reverse_complement(x)], dim=0)
    seq, last = rnn_apply(_rnn_params(params), both)
    avg = (seq[:batch] + seq[batch:]) * 0.5
    hidden = (last[:batch] + last[batch:]) * 0.5
    return head_logits(params, avg, hidden, config)


def forward(params: Params, x: torch.Tensor, config: ModelConfig,
            rnn_apply: Optional[RnnApply] = None) -> torch.Tensor:
    """One-hot windows ``x [B, T, 5]`` -> class probabilities ``[B, T,
    n_classes]`` in ``x``'s dtype (``model.py:130-144``)."""
    return torch.softmax(forward_logits(params, x, config, rnn_apply),
                         dim=-1)


def forward_logits_from_codes(params: Params, codes: torch.Tensor,
                              config: ModelConfig,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Integer code windows ``[B, T]`` -> logits ``[B, T, n_classes]``
    through the inference kernels (no dropout).  In bfloat16 the kernel
    stores bfloat16 and the head runs in bfloat16 (``model.py:248-260``);
    the recurrence's parameters stay float32."""
    rnn_avg = cuda_rnn.lstm_avg if config.rnn == "LSTM" else cuda_rnn.gru_avg
    avg, hidden = rnn_avg(_rnn_params(params), codes, compute_dtype)
    head = {key: value for key, value in params.items()
            if not key.startswith("rnn.")}
    return head_logits(_cast(head, compute_dtype), avg, hidden, config)


def forward_probs_from_codes(params: Params, codes: torch.Tensor,
                             config: ModelConfig,
                             compute_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Integer code windows ``[B, T]`` -> class probabilities
    ``[B, T, n_classes]`` in ``compute_dtype`` (float32 or bfloat16)."""
    return torch.softmax(forward_logits_from_codes(params, codes, config,
                                                   compute_dtype), dim=-1)


def forward_logits_from_codes_train(params: Params, codes: torch.Tensor,
                                    config: ModelConfig,
                                    masks: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """Trainable forward: integer code windows ``[B, T]`` -> logits
    (``model.py:191-228``).

    The recurrence runs through the training kernels' autograd Function
    (:class:`~deepgrp_tpu_torch.models.cuda_rnn.GruAvgTrain` /
    ``LstmAvgTrain``), with Keras input dropout as per-gate scales
    ``masks [g, 2B, 5]`` over the doubled batch (``None``: no dropout);
    the head is plain torch, differentiated by autograd.
    """
    cell = "lstm" if config.rnn == "LSTM" else "gru"
    avg, hidden = cuda_rnn.avg_train(cell, _rnn_params(params), codes, masks)
    return head_logits(params, avg, hidden, config)


def resolve_rnn_kernel(mode: str) -> bool:
    """Whether a route is the fused one (``engine.py:587-609``,
    ``training.py:233-253``).

    ``"fused"`` and ``"scan"`` force a route; ``"auto"`` is the fused
    route on every device, for predict and train.  The JAX package's
    ``auto`` keeps the scan off the TPU because its fused kernel would run
    in the slow Pallas interpreter there; the port's fused route on the CPU
    runs the exact plain version of the kernel instead, so ``auto`` keeps
    the route the port has taken since it began, on the card and on the
    CPU.
    """
    if mode not in ("auto", "scan", "fused"):
        raise ValueError(f"rnn_kernel must be auto|scan|fused, got {mode!r}")
    return mode != "scan"


def one_hot(codes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Code windows ``[B, T]`` -> one-hot ``[B, T, 5]`` in ``dtype``; pad
    code 5 gives the all-zero row (``engine.py:67-70``; the one-hot
    sequence's hard-masked columns)."""
    eye = torch.eye(PAD_CODE + 1, dtype=dtype, device=codes.device)
    return eye[codes.long()][..., :PAD_CODE]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; raises for CUDA when no GPU is available
    (entry points never carry on on the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return device


class DeepGRPModel(nn.Module):
    """The classifier's parameters on one device, in float32.

    The parameters are ``nn.Parameter``s of three submodules, so
    ``state_dict()`` keys are the flat names listed in the module
    docstring; inference runs under ``torch.no_grad()``.
    """

    def __init__(self, config: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        for key, shape in config.param_shapes().items():
            group, name = key.split(".")
            if not hasattr(self, group):
                self.add_module(group, nn.Module())
            getattr(self, group).register_parameter(
                name, nn.Parameter(torch.zeros(shape, device=device)))

    @classmethod
    def from_params(cls, config: ModelConfig, params: Params,
                    device: Union[str, torch.device] = "cuda"
                    ) -> "DeepGRPModel":
        """Model holding ``params`` (copied to ``device``; names and shapes
        must match the config)."""
        model = cls(config, device)
        model.load_state_dict(dict(params))
        return model

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters by flat name."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def forward_probs_from_codes(self, codes: torch.Tensor,
                                 compute_dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
        """Class probabilities ``[B, T, n_classes]`` in ``compute_dtype``
        for code windows ``[B, T]`` (int8 on a CUDA device)."""
        return forward_probs_from_codes(self.params(), codes, self.config,
                                        compute_dtype)

    @torch.no_grad()
    def apply(self, x: torch.Tensor,
              rnn_apply: Optional[RnnApply] = None) -> torch.Tensor:
        """Class probabilities for one-hot windows ``x [B, T, 5]`` (float32
        or bfloat16) through the one-hot route (:func:`forward`); the JAX
        package's ``DeepGRPModel.apply``.  (It takes the place of
        ``nn.Module.apply``, which this model does not use.)"""
        return forward(self.params(), x, self.config, rnn_apply)

    def apply_logits(self, x: torch.Tensor,
                     rnn_apply: Optional[RnnApply] = None,
                     masks: Optional[torch.Tensor] = None,
                     train: bool = False) -> torch.Tensor:
        """Logits for one-hot windows ``x [B, T, 5]`` (:func:`
        forward_logits`); autograd records only the training form."""
        with torch.set_grad_enabled(train):
            return forward_logits(self.params(), x, self.config, rnn_apply,
                                  masks, train)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        return self.forward_probs_from_codes(codes)


def create_model(options: Any, device: Union[str, torch.device] = "cuda"
                 ) -> DeepGRPModel:
    """The model of a run's :class:`~deepgrp_tpu_torch.config.Options` on
    ``device`` (``create_model``, ``deepgrp_tpu/models/model.py:309``; the
    reference's ``model.py:293-336``), its parameters zero until trained or
    loaded (``load_state_dict``)."""
    return DeepGRPModel(ModelConfig.from_options(options), device)
