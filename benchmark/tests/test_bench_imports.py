"""Nothing under benchmark/ imports JAX or the JAX package, by top-level
name compared whole; the reference imports nothing of the measured
program either. A run's own check of ``sys.modules`` compares the same way."""
import ast
import sys
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "audiossl_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere_in_the_benchmark():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    found = {str(f.relative_to(BENCH)): top_level_imports(f) & JAX
             for f in files}
    assert not {f: n for f, n in found.items() if n}
    # the port's name begins with the JAX package's: compared whole, it is
    # allowed
    assert "audiossl_tpu_torch" in set().union(
        *(top_level_imports(f) for f in files))


def test_reference_takes_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = top_level_imports(f)
        assert not names & (JAX | {"audiossl_tpu_torch", "harness"}), f


def test_run_checks_modules_by_whole_top_level_name(monkeypatch):
    for name in [m for m in list(sys.modules) if m.split(".")[0] in JAX]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "audiossl_tpu_torch_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "audiossl_tpu.models", object())
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert run.forbidden_modules() == ["audiossl_tpu", "flax"]
