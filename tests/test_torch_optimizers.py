"""The port's optimizer names against optax: every optax name the port
maps (``getattr(optax, name.lower())(learning_rate=lr)`` in the JAX
package, ``deepgrp_tpu/train/optimizers.py:35-38``) takes the same three
steps on the same parameters and gradients, and every other name raises
``ValueError``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import optax  # noqa: E402
import torch  # noqa: E402

from deepgrp_tpu.config import Options as JaxOptions  # noqa: E402
from deepgrp_tpu.train.optimizers import \
    get_optimizer as jax_get_optimizer  # noqa: E402
from deepgrp_tpu_torch.config import Options  # noqa: E402
from deepgrp_tpu_torch.train.optimizers import (  # noqa: E402
    CAPTURABLE, OPTAX_DEFAULTS, Adagrad, RMSprop, fleet_optimizer,
    get_optimizer)

MAPPED = ["adam", "rmsprop", "sgd", "adagrad", "adadelta", "adamax",
          "adamw"]
REFUSED = ["amsgrad", "nadam", "nadamw", "radam", "lamb", "lion", "lars",
           "novograd", "yogi", "no_such_optimizer"]
SHAPES = [(5, 12), (4, 12), (2, 12), (8, 5), (5,)]


def three_steps(name, learning_rate=0.01, seed=0):
    """The parameters after each of three steps: (port, optax)."""
    rng = np.random.default_rng(seed)
    start = [rng.normal(0.0, 0.5, shape).astype(np.float32)
             for shape in SHAPES]
    grads = [[rng.normal(0.0, scale, shape).astype(np.float32)
              for shape in SHAPES] for scale in (1.0, 0.1, 0.01)]
    params = [torch.tensor(p, requires_grad=True) for p in start]
    optimizer = get_optimizer(Options(optimizer=name,
                                      learning_rate=learning_rate), params)
    jax_opt = jax_get_optimizer(JaxOptions(optimizer=name,
                                           learning_rate=learning_rate))
    jax_params = [jax.numpy.asarray(p) for p in start]
    state = jax_opt.init(jax_params)
    got, want = [], []
    for step in grads:
        for param, grad in zip(params, step):
            param.grad = torch.from_numpy(grad.copy())
        optimizer.step()
        updates, state = jax_opt.update([jax.numpy.asarray(g) for g in step],
                                        state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        got.append([p.detach().numpy().copy() for p in params])
        want.append([np.asarray(p) for p in jax_params])
    return start, got, want


@pytest.mark.parametrize("name", MAPPED + ["Adagrad", "ADAMW", "SGD"])
def test_mapped_optimizer_equals_optax(name):
    start, got, want = three_steps(name)
    for got_step, want_step in zip(got, want):
        for g, w, s in zip(got_step, want_step, start):
            assert not np.array_equal(w, s)  # the step moved it
            scale = np.abs(w).max()
            assert np.abs(g - w).max() <= 1e-6 * scale, (name, g, w)


def test_mapped_set_is_the_tested_set():
    assert sorted(OPTAX_DEFAULTS) == sorted(MAPPED)


@pytest.mark.parametrize("name", REFUSED)
def test_unmapped_optimizer_raises(name):
    params = [torch.zeros(3, requires_grad=True)]
    with pytest.raises(ValueError, match="adadelta"):
        get_optimizer(Options(optimizer=name), params)


def test_tf_named_optimizers_keep_options():
    """``RMSprop`` and ``Adam`` map the TF parameters (``rho``,
    ``momentum``, ``epsilon``); their lowercase names take optax's
    defaults, as in the JAX package."""
    params = [torch.zeros(3, requires_grad=True)]
    options = Options(optimizer="Adam", momentum=0.5, rho=0.9, epsilon=1e-4)
    adam = get_optimizer(options, params)
    assert adam.defaults["betas"] == (0.5, 0.9)
    assert adam.defaults["eps"] == 1e-4
    options.optimizer = "adam"
    adam = get_optimizer(options, params)
    assert adam.defaults["betas"] == (0.9, 0.999)
    assert adam.defaults["eps"] == 1e-8
    options.optimizer = "rmsprop"
    rmsprop = get_optimizer(options, params)
    assert (rmsprop.defaults["rho"], rmsprop.defaults["eps"],
            rmsprop.defaults["momentum"]) == (0.9, 1e-8, None)


def test_adagrad_is_the_ports_own_and_equals_optax():
    """``adagrad`` is the port's class (state in tensors: a CUDA graph can
    capture its step), optax's update over three steps at atol 1e-6."""
    params = [torch.zeros(3, requires_grad=True)]
    assert type(get_optimizer(Options(optimizer="adagrad"), params)) \
        is Adagrad
    _, got, want = three_steps("adagrad")
    for got_step, want_step in zip(got, want):
        for g, w in zip(got_step, want_step):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", MAPPED + ["RMSprop", "Adam"])
def test_every_mapped_optimizer_can_be_captured(name):
    """Each name's optimizer holds its state in tensors (the port's
    classes), has none (``sgd``), or takes ``capturable``, which it gets
    for CUDA parameters only (``CAPTURABLE``; off on the CPU)."""
    optimizer = get_optimizer(Options(optimizer=name),
                              [torch.zeros(3, requires_grad=True)])
    if isinstance(optimizer, (RMSprop, Adagrad)):
        return
    if type(optimizer) is torch.optim.SGD:
        assert optimizer.defaults["momentum"] == 0
        return
    assert type(optimizer) in CAPTURABLE
    assert optimizer.defaults["capturable"] is False


def test_fleet_optimizer_names():
    """The fleet takes RMSprop and Adam (Adam capturable on CUDA only)
    and refuses every other name."""
    hp = {"learning_rate": 0.01, "rho": 0.9, "epsilon": 1e-7,
          "momentum": 0.5}
    trial = [([torch.zeros(3, requires_grad=True)], hp)]
    assert type(fleet_optimizer("RMSprop", trial)) is RMSprop
    adam = fleet_optimizer("Adam", trial)
    assert type(adam) is torch.optim.Adam
    assert adam.defaults["capturable"] is False
    with pytest.raises(ValueError, match="RMSprop/Adam"):
        fleet_optimizer("adagrad", trial)
