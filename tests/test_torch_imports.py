"""The port stands alone: no module of src/repro_torch/, and neither
chip_smoke.py nor kernel_ab.py nor the spawned ranks' workers
(tests/torch_*_worker.py), imports jax or the reference package
``repro`` (checked on the source with ``ast``, so nothing is imported to
check it)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                 ROOT / "kernel_ab.py"]
# the workers of spawned ranks: a rank re-imports its target's module
FILES += sorted((ROOT / "tests").glob("torch_*_worker.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_has_sources():
    assert len(FILES) > 20, FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports():
    src = "import jax\nfrom repro.core import mx\nfrom repro_torch.core import mx\n"
    names = [n for _, n in _imports(ast.parse(src)) if _forbidden(n)]
    assert names == ["jax", "repro.core"]
