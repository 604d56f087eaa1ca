"""No JAX and no ``pesr_tpu`` in a run, by whole top-level module name;
the references and the traffic import nothing of the program."""

import ast
import pathlib
import sys

import pytest

from port_bench import run

HERE = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("loaded, found", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["jaxlib.xla"], ["jaxlib"]),
    (["flax.linen"], ["flax"]), (["pesr_tpu.models"], ["pesr_tpu"]),
    (["pesr_torch", "pesr_torch.ops", "jaxtyping", "pesr_tpu_x", "flaxen"],
     []),
])
def test_whole_name_check(monkeypatch, loaded, found):
    fake = {name: object() for name in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == found


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(HERE / path)}
    assert not tops & set(run.FORBIDDEN)
    if path.startswith(("reference/", "traffic/", "metrics/", "trace")):
        assert "pesr_torch" not in tops
