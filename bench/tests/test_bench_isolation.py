"""Nothing under bench/ imports JAX, the JAX package or benchmarks/; the
reference imports nothing of the port."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: pathlib.Path) -> set[str]:
    """Top-level names of every module the file imports, compared whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_no_jax_package_no_benchmarks(path):
    found = top_level_imports(path) & BANNED
    assert not found, f"{path} imports {found}"
    if path.name != "test_bench_isolation.py":
        assert "benchmarks/" not in path.read_text()


def test_prefix_match_is_whole():
    # the port's name begins with the JAX package's: not a match
    assert "repro_torch".split(".")[0] not in BANNED


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    for name in top_level_imports(path):
        assert name in {"__future__", "dataclasses", "numpy", "torch",
                        "bench"}, name
