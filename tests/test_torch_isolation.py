"""The port stands alone: it imports neither JAX nor the JAX package."""

import os
import pkgutil
import re
import subprocess
import sys

import deepgrp_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "deepgrp_tpu_torch")


def port_modules():
    return sorted(info.name for info in pkgutil.walk_packages(
        deepgrp_tpu_torch.__path__, "deepgrp_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    modules = port_modules()
    for name in ("models.cuda_rnn", "train.sampler", "train.optimizers",
                 "train.checkpoint", "train.training", "data.preprocess",
                 "hpo", "hpo.space", "hpo.tpe", "hpo.optimization",
                 "hpo.vmapped", "hpo.bucketed", "utils.tb_events",
                 "parallel", "parallel.mesh", "parallel.predict",
                 "parallel.train", "ops.mss_device", "data.fasta",
                 "data.parse_rm", "data.preprocess_sequence",
                 "models.keras_io", "__main__"):
        assert f"deepgrp_tpu_torch.{name}" in modules, name
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'deepgrp_tpu' or "
            "m.startswith('deepgrp_tpu.'))\n"
            "print(len(bad)); print(bad)\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                            capture_output=True, text=True, timeout=300,
                            check=True)
    assert result.stdout.splitlines()[0] == "0", result.stdout


def test_sources_name_no_jax():
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    jax_import = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    jax_pkg = re.compile(r"\bdeepgrp_tpu\b(?!_torch)")
    for path in sources:
        with open(path) as fh:
            text = fh.read()
        assert not jax_import.search(text), path
        for line in text.splitlines():
            # Comments and docstrings may name the JAX package's files (the
            # counterpart of each module); code may not import it.
            if re.match(r"\s*(import|from)\s", line):
                assert not jax_pkg.search(line), (path, line)
