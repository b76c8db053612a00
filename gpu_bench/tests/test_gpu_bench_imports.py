"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the port: every module that a file
under gpu_bench/ imports, by its top-level name."""
import ast

import pytest

from small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "forest_tpu"}


def imported(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted((ROOT / "gpu_bench").rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN
    if "reference" in path.relative_to(ROOT / "gpu_bench").parts:
        assert "forest_tpu_torch" not in imported(path)
