"""What the benchmark may import: nothing of JAX, jaxlib, Flax or the JAX
package anywhere under pdbench/ (top-level names compared whole, so the
port's `prompt_diffusion_tpu_torch` is not the JAX package), and nothing
of the port in the reference."""

import ast
import os

import pytest

from pdbench import run

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "prompt_diffusion_tpu"}


def _sources(sub=""):
    for dirpath, _, names in os.walk(os.path.join(PKG, sub)):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_port(path):
    assert "prompt_diffusion_tpu_torch" not in set(_imports(path))


def test_the_run_names_what_it_found(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "prompt_diffusion_tpu_torch_fake", object())
    assert "prompt_diffusion_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "prompt_diffusion_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "prompt_diffusion_tpu"]


def test_the_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "sd15.int8.b8", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
