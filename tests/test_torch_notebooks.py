"""The port's notebooks (``deepgrp_tpu_torch/notebooks/``) stay valid, as
``tests/test_notebooks.py`` holds the JAX package's: parseable nbformat-4
JSON, every code cell compiles, every ``deepgrp_tpu_torch`` name they
import resolves, they import nothing of the JAX package, and the first
code cell sets ``DEVICE = "cuda"`` (the executable equivalents are
``deepgrp_tpu_torch/examples/*.py``)."""

import ast
import importlib
import json
import os

import pytest

NOTEBOOK_DIR = os.path.join(os.path.dirname(__file__), "..",
                            "deepgrp_tpu_torch", "notebooks")
NOTEBOOKS = ["Training.ipynb", "DeepGRP.ipynb"]


def code_cells(name):
    with open(os.path.join(NOTEBOOK_DIR, name)) as fh:
        nb = json.load(fh)
    assert nb["nbformat"] == 4
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_code_cells_compile_and_imports_resolve(name):
    cells = code_cells(name)
    assert len(cells) >= 4
    imported = 0
    for i, src in enumerate(cells):
        tree = compile(src, f"{name}[{i}]", "exec", ast.PyCF_ONLY_AST)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    assert alias.name.split(".")[0] != "deepgrp_tpu", (
                        name, alias.name)
            if isinstance(node, ast.ImportFrom) and node.module:
                root = node.module.split(".")[0]
                assert root not in ("deepgrp_tpu", "jax"), (name,
                                                            node.module)
                if root == "deepgrp_tpu_torch":
                    mod = importlib.import_module(node.module)
                    for alias in node.names:
                        assert hasattr(mod, alias.name), (
                            f"{name}: {node.module}.{alias.name} missing")
                        imported += 1
    assert imported >= 5


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_first_cell_sets_the_device(name):
    tree = ast.parse(code_cells(name)[0])
    devices = [node.value.value for node in tree.body
               if isinstance(node, ast.Assign)
               and [t.id for t in node.targets
                    if isinstance(t, ast.Name)] == ["DEVICE"]]
    assert devices == ["cuda"]
