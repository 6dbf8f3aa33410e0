"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gpu_fft_tpu"}


def imported_top_names(path: Path) -> set[str]:
    """Top-level names (before the first dot) of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "gpu_fft_tpu_torch" not in imported_top_names(path)


def test_the_whole_name_is_compared(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import gpu_fft_tpu_torch\nfrom gpu_fft_tpu_torch.ops import fft2d\n")
    assert not imported_top_names(f) & FORBIDDEN
    f.write_text("from gpu_fft_tpu.kernels import fused\n")
    assert imported_top_names(f) & FORBIDDEN == {"gpu_fft_tpu"}
