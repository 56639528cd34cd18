"""The import rule of the benchmark, read from the sources: no module under
``benchmark/`` imports JAX, jaxlib, flax or the JAX package ``vqvae_tpu``
(top-level names compared whole: ``vqvae_tpu_torch`` is not
``vqvae_tpu``), and nothing under ``benchmark/reference/`` imports the
port, ``vqvae_tpu_torch``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "vqvae_tpu"}


def top_level_imports(path: Path) -> set:
    """The top-level package of every absolute import in a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_apart_from_the_port(path):
    imported = top_level_imports(path)
    assert "vqvae_tpu_torch" not in imported
    assert not imported & JAX_SIDE


def test_the_rule_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import vqvae_tpu_torch.models\nfrom vqvae_tpu.ops import vq\n")
    assert top_level_imports(src) == {"vqvae_tpu_torch", "vqvae_tpu"}
    assert top_level_imports(src) & JAX_SIDE == {"vqvae_tpu"}
