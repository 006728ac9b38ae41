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
@pytest.mark.parametrize("engine", ["pkt", "dist", "trilist", "wc", "ros"])
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
    """The host tuning flag of the JAX package's CLI is out of the port's
    scope: absent, not stubbed."""
    for flag in (["--tune-env"],):
        with pytest.raises(SystemExit):
            port_main(["--graph", "fig1", "--device", "cpu", *flag])


def _kind_counts(out: str):
    """``{kind: completed requests}`` from a ``--serve`` run's latency
    lines."""
    return dict(re.findall(r"^(query|update|open)\s+n=\s*(\d+)", out,
                           re.MULTILINE))


def test_cli_serve_matches_reference(capsys):
    """``--serve`` on ``cliques-tiny``: the port's synchronous replay
    agrees bitwise, and the seeded 90/9/1 schedule has the reference's
    request mix."""
    args = ["--graph", "cliques-tiny", "--serve", "60", "--qps", "300"]
    port_main([*args, "--verify", "--device", "cpu"])
    got = capsys.readouterr().out
    assert "verify async vs sync engine (failed ops masked): OK" in got
    assert "device=cpu" in got and "dispatches=" in got
    ref_main(args)
    want = capsys.readouterr().out
    assert _kind_counts(got) == _kind_counts(want) == \
        {"query": "47", "update": "11", "open": "2"}


def test_cli_serve_under_faults_and_deadlines(capsys):
    """``--fault-rate`` and ``--deadline-ms``: failed requests are typed
    and masked, every completed one still agrees with the sync replay."""
    port_main(["--graph", "rmat-tiny", "--serve", "60", "--qps", "300",
               "--fault-rate", "0.1", "--deadline-ms", "250", "--verify",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"chaos: availability \d+/60", out)
    assert "rungs=flush:" in out
    assert "verify async vs sync engine (failed ops masked): OK" in out


def _stream_summary(out: str):
    """The update-stream and community lines of one CLI run, without the
    times: per batch its counts and repair, the stream's local/full split,
    the index's levels and stats and the level-k community sizes."""
    keep = []
    for ln in out.splitlines():
        if ln.startswith("batch "):
            keep.append(ln.rsplit(" ", 1)[0])
        elif ln.startswith("stream done:"):
            keep.append(ln.split(", mean")[0])
        elif ln.startswith("community index:"):
            keep.append(re.sub(r" build \S+ ", " ", ln.split(
                ") flood_rounds")[0].rstrip(")")))
        elif re.match(r"k=\d+:", ln):
            keep.append(ln.split(", query")[0])
    return keep


@pytest.mark.parametrize("flags", [
    ["--update-stream", "3", "--churn", "0.05"],
    ["--update-stream", "2", "--churn", "0.02", "--insert-mode",
     "sequential", "--local-frac", "1.0"],
    ["--query-communities", "3"],
    ["--update-stream", "2", "--churn", "0.02", "--local-frac", "1.0",
     "--query-communities", "4", "--hier-mode", "host"],
])
def test_cli_updates_and_communities_match_reference(flags, capsys):
    """``--update-stream`` and ``--query-communities`` on ``cliques-tiny``:
    the port's own ``--verify`` passes (from-scratch ``truss_pkt``, the
    other index builder) and every summary line equals the reference's."""
    port_main(["--graph", "cliques-tiny", "--device", "cpu", "--verify",
               *flags])
    got = capsys.readouterr().out
    if "--update-stream" in flags:
        assert "verify vs from-scratch pkt: OK" in got
    if "--query-communities" in flags:
        assert re.search(r"verify (device|host) labels vs \w+ builder: OK",
                         got)
    ref_main(["--graph", "cliques-tiny", *flags])
    want = capsys.readouterr().out
    assert _stream_summary(got) and _stream_summary(got) == \
        _stream_summary(want)
