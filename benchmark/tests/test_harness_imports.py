"""What the benchmark imports, by an AST scan compared by whole top-level
names: the port's name begins with the JAX package's, so a prefix test
would be wrong both ways."""

import ast

import pytest
from conftest import ROOT

BENCH = ROOT / "benchmark"
JAX_STACK = {"jax", "jaxlib", "flax", "optax", "vision_assist_tpu"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.relative_to(BENCH).parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_names_are_compared_whole():
    assert "vision_assist_tpu_torch".split(".")[0] not in JAX_STACK
    assert "vision_assist_tpu.models".split(".")[0] in JAX_STACK


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_the_jax_stack(path):
    assert not top_level_imports(path) & JAX_STACK


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert "vision_assist_tpu_torch" not in found
    assert found <= {"__future__", "dataclasses", "enum", "heapq", "math", "typing",
                     "pathlib", "struct", "numpy", "torch", "benchmark"}
    if "benchmark" in found:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), node.module


def test_the_harness_reads_no_older_measurement_piece():
    banned = {"chip_smoke", "bench"}
    for path in (p for p in FILES if "tests" not in p.relative_to(BENCH).parts):
        assert not top_level_imports(path) & banned, path
        text = path.read_text()
        for piece in ("vision_assist_tpu_torch.tools", "vision_assist_tpu_torch.utils.profil",
                      "vision_assist_tpu_torch.bench"):
            assert piece not in text, (path, piece)
