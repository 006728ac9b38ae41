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


def test_serving_and_dist_entry_points_refuse_to_run_on_cpu_by_default(
        monkeypatch):
    """Without a card ``TrussScheduler()`` and ``pkt_dist`` raise unless
    asked for the CPU; with ``device="cpu"`` they serve."""
    from repro_torch.core import pkt_dist
    from repro_torch.graphs.csr import build_csr
    from repro_torch.serve import TrussScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([[0, 1], [0, 2], [1, 2], [2, 3]], np.int64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrussScheduler()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrussScheduler(start=False, max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pkt_dist(build_csr(edges))
    # asking for the CPU is the explicit opt-in
    assert pkt_dist(build_csr(edges), device="cpu").tolist() == [3, 3, 3, 2]
    with TrussScheduler(device="cpu") as sched:
        assert sched.submit_async(edges).result(timeout=60).tolist() == \
            [3, 3, 3, 2]


def test_serving_paths_route_every_broad_except(tmp_path):
    """trusslint's R001 over the port's serving files: every broad
    ``except`` re-raises or routes the error into ``_finish`` /
    ``set_exception`` — failures on the serving path are typed, never
    swallowed.  The repo's lint configuration names the JAX package's
    serving files; this widens it to the port's for the check."""
    import dataclasses

    from repro.analysis.config import load_config
    from repro.analysis.engine import run_paths

    cfg = dataclasses.replace(load_config(ROOT), fault_paths=(
        "src/repro_torch/serve/*", "src/repro_torch/core/truss_inc.py"))
    paths = [str(p.relative_to(ROOT)) for p in
             sorted((PORT / "serve").glob("*.py"))
             + [PORT / "core" / "truss_inc.py"]]
    findings = run_paths(paths, cfg, ROOT)
    r001 = [f for f in findings if f.rule == "R001"]
    assert r001 == [], "\n".join(f.render() for f in r001)
    # the check is live: a copy of the scheduler with one more broad
    # handler that swallows its error is flagged
    bad = tmp_path / "src" / "repro_torch" / "serve" / "scheduler.py"
    bad.parent.mkdir(parents=True)
    bad.write_text((PORT / "serve" / "scheduler.py").read_text()
                   + "\n\ndef _swallow(fn):\n    try:\n        fn()\n"
                     "    except Exception:\n        pass\n")
    assert [f.rule for f in run_paths(
        ["src/repro_torch/serve/scheduler.py"], cfg, tmp_path)
            if f.rule == "R001"] == ["R001"]


def test_kernel_modules_do_not_build_at_import():
    """Importing the kernel modules compiles nothing and loads no library."""
    from repro_torch.kernels import cuda_build

    assert cuda_build._loaded == {}
