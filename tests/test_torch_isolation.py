"""The port stands alone: no JAX, no reference package, no silent CPU runs."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax():
    """A fresh interpreter in which ``import jax`` fails imports them all."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for name in {_port_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k in sys.modules if sys.modules[k] is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_refuse_to_run_on_cpu_by_default(monkeypatch):
    """Without a card, a call that did not ask for the CPU raises."""
    import repro_torch
    from repro_torch.core.support import compute_support
    from repro_torch.graphs.csr import build_csr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([[0, 1], [1, 2], [0, 2]], np.int64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.truss_pkt(edges)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.pkt(build_csr(edges))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_support(build_csr(edges))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.TrussEngine()
    # asking for the CPU is the explicit opt-in
    assert (repro_torch.truss_pkt(edges, device="cpu") == 3).all()
    with pytest.raises(ValueError, match="device"):
        repro_torch.resolve_device("meta")


def test_handle_entry_points_refuse_to_run_on_cpu_by_default(monkeypatch):
    """Without a card the handle path raises unless it asked for the CPU:
    ``IncrementalTruss`` (both constructors), ``TrussEngine().open``, the
    community index and the device triangle list."""
    import repro_torch
    from repro_torch.core.hierarchy import (TrussHierarchy,
                                            hierarchy_from_graph)
    from repro_torch.core.truss_inc import IncrementalTruss, triangle_list
    from repro_torch.graphs.csr import build_csr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([[0, 1], [0, 2], [1, 2]], np.int64)
    tri = np.array([[0, 1, 2]], np.int64)
    T, S = np.full(3, 3, np.int64), np.ones(3, np.int32)
    calls = [lambda: IncrementalTruss(edges),
             lambda: IncrementalTruss.from_state(edges, T, S, tri),
             lambda: repro_torch.TrussEngine().open(edges),
             lambda: TrussHierarchy(T, tri),
             lambda: TrussHierarchy(T, tri, mode="host"),
             lambda: hierarchy_from_graph(build_csr(edges), T),
             lambda: triangle_list(build_csr(edges))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asking for the CPU is the explicit opt-in
    h = repro_torch.TrussEngine(device="cpu").open(edges)
    assert (h.trussness == 3).all()
    assert h.communities(3)[0].shape == (3, 2)
    assert IncrementalTruss.from_state(edges, T, S, tri,
                                       device="cpu").verify()


def test_kernel_modules_do_not_build_at_import():
    """Importing the kernel modules compiles nothing and loads no library."""
    from repro_torch.kernels import cuda_build

    assert cuda_build._loaded == {}
