"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared whole
(mvslam_tpu_torch begins with mvslam_tpu)."""

import ast

import pytest

from portbench import spec

FILES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "mvslam_tpu"}


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name == "reference"], ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mvslam_tpu_torch" not in top_level_imports(path)


def test_whole_name_comparison():
    from portbench.run import forbidden_modules

    import sys

    sys.modules["mvslam_tpu_torch_probe"] = object()
    try:
        assert "mvslam_tpu_torch_probe" not in forbidden_modules()
    finally:
        del sys.modules["mvslam_tpu_torch_probe"]
