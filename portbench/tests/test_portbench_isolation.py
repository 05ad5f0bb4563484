"""Nothing of the benchmark imports JAX or the JAX package (by whole
top-level name), the plain reference imports nothing of the program,
and nothing the benchmark reads lies under the JAX package's benchmark
folder."""
import ast
from pathlib import Path

from conftest import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "rapid_tpu"}


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                  p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere():
    found = {(str(p.relative_to(ROOT)), name) for p in _modules()
             for name in _imports(p) if name in FORBIDDEN}
    assert not found
    # the port's name begins with the JAX package's and is allowed
    assert "rapid_tpu_torch" not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    used = {name for p in (BENCH / "reference").rglob("*.py")
            for name in _imports(p)}
    assert used <= {"__future__", "numpy", "torch", "portbench"}, used
    # and, inside the benchmark, only the reference's own modules
    for p in (BENCH / "reference").rglob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), (
                    p, node.module)


def test_nothing_reads_the_jax_benchmarks():
    for p in _modules():
        if p.parent.name == "tests":
            continue
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                parts = node.value.replace("\\", "/").split("/")
                assert "benchmarks" not in parts, (p, node.value)
                assert "bench.py" not in parts, (p, node.value)
