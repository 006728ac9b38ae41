"""Port parity: the one-shot CLI (``repro_torch.launch.truss``).

Each engine runs through the port's CLI on the CPU with ``--verify`` and
through the JAX package's CLI on the same named graph; the ``t_max`` and
the k-class histogram lines must be equal.
"""

import re

import pytest
import torch

from repro.launch.truss import main as ref_main

from repro_torch.launch.truss import main as port_main


def _summary(out: str):
    """``(t_max, histogram line)`` of one CLI run's output."""
    t_max = re.search(r"t_max (\d+)", out).group(1)
    hist = [ln for ln in out.splitlines()
            if ln.startswith("largest k-classes:")]
    assert len(hist) == 1, out
    return t_max, hist[0]


@pytest.mark.parametrize("graph", ["fig1", "cliques-tiny"])
@pytest.mark.parametrize("engine", ["pkt", "trilist", "wc", "ros"])
def test_cli_summary_matches_reference(graph, engine, capsys):
    port_main(["--graph", graph, "--engine", engine, "--device", "cpu",
               "--verify"])
    got = capsys.readouterr().out
    assert "verify vs oracle: OK" in got
    assert f"engine={engine} " in got and "device=cpu" in got
    ref_main(["--graph", graph, "--engine", engine])
    want = capsys.readouterr().out
    assert _summary(got) == _summary(want)


@pytest.mark.parametrize("flags", [
    ["--mode", "chunked", "--support-mode", "torch"],
    ["--mode", "dense", "--table-mode", "numpy", "--compact-frac", "0"],
    ["--order", "natural", "--chunk", "8"],
])
def test_cli_pkt_executors(flags, capsys):
    """The pkt engine's executor, table and order flags reach ``pkt``."""
    port_main(["--graph", "karate_like", "--device", "cpu", "--verify",
               *flags])
    out = capsys.readouterr().out
    assert "verify vs oracle: OK" in out
    assert "levels=" in out and "sublevels=" in out


def test_cli_refuses_without_a_card(monkeypatch):
    """The CLI runs on the card by default and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["--graph", "fig1"])


def test_cli_has_only_the_ported_paths():
    """Paths that are not ported yet are absent, not stubbed."""
    for flag in (["--engine", "dist"], ["--update-stream", "2"],
                 ["--serve", "4"], ["--tune-env"]):
        with pytest.raises(SystemExit):
            port_main(["--graph", "fig1", "--device", "cpu", *flag])
