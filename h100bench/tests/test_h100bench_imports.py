"""What the benchmark's modules import, read from their source: no module
imports JAX or the JAX package (top-level names compared whole, so
``autovc_tpu_torch`` is not ``autovc_tpu``), and the plain reference and
the cost arithmetic import nothing of the program either."""
import ast

import pytest

from conftest import REPO

BENCH = REPO / "h100bench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax",
                                          "autovc_tpu"}


@pytest.mark.parametrize("name", ["configs/autovc_ref.py", "costs.py",
                                  "traffic.py", "weights.py", "trace.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "autovc_tpu_torch" not in top_level_imports(BENCH / name)


def test_whole_name_comparison():
    from h100bench import harness
    assert harness.forbidden_modules(["autovc_tpu_torch.ops", "torch",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["autovc_tpu.models", "jax.numpy",
                                      "jaxlib"]) == ["autovc_tpu", "jax",
                                                     "jaxlib"]
