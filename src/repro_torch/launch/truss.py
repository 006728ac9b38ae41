"""Truss decomposition CLI of the port — the one-shot pipeline end to end.

  PYTHONPATH=src python -m repro_torch.launch.truss --graph rmat-small \
      [--order kco|natural] [--engine pkt|trilist|wc|ros] [--verify] \
      [--device cuda|cpu]

Loads a named graph, relabels it by degeneracy order (``--order kco``),
builds the CSR graph and decomposes it with one engine: PKT (``pkt``, with
its executors), the triangle-list peel (``trilist``), or the paper's
baselines WC (``wc``, a host loop) and Ros (``ros``, support on the
device).  It prints the same summary lines as the JAX package's CLI;
``--verify`` checks the trussness against the numpy oracle (small graphs).
The work runs on ``--device`` ("cuda" by default; without a card the
CLI refuses to run unless given ``--device cpu``, where every "kernel"
executor runs its plain PyTorch version).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (pkt, truss_numpy, truss_ros, truss_trilist,
                              truss_wc)
from repro_torch.core.pkt import PEEL_MODES
from repro_torch.core.support import SUPPORT_MODES, TABLE_MODES
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.graphs.csr import build_csr, degeneracy_order, relabel
from repro_torch.graphs.datasets import named_graph

ENGINES = ("pkt", "trilist", "wc", "ros")


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags (``argv=None`` reads the command line)."""
    ap = argparse.ArgumentParser(
        description="One-shot truss decomposition on the port")
    ap.add_argument("--graph", default="rmat-small")
    ap.add_argument("--order", default="kco", choices=["kco", "natural"])
    ap.add_argument("--engine", default="pkt", choices=list(ENGINES))
    ap.add_argument("--chunk", type=int, default=None,
                    help="peel chunk size (default: derived from the table "
                         "size, see kernels.wedge_common.auto_chunk)")
    ap.add_argument("--mode", default="kernel", choices=list(PEEL_MODES),
                    help="peel executor of --engine pkt")
    ap.add_argument("--support-mode", default="kernel",
                    choices=list(SUPPORT_MODES),
                    help="support executor of --engine pkt")
    ap.add_argument("--table-mode", default="device",
                    choices=list(TABLE_MODES),
                    help="where wedge tables are built: torch ops on the "
                         "device (default) or host numpy (parity oracle)")
    ap.add_argument("--compact-frac", type=float, default=0.25,
                    help="live-edge compaction threshold for the peel loop "
                         "(0 disables; see DESIGN.md §10)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the engines run: cuda (default) or cpu")
    ap.add_argument("--verify", action="store_true",
                    help="check against the numpy oracle (small graphs!)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    """Run one decomposition and print its summary; exit 1 on a mismatch."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    E = named_graph(args.graph)
    n = int(E.max()) + 1
    t0 = time.perf_counter()
    if args.order == "kco":
        E = relabel(E, degeneracy_order(E, n))
    g = build_csr(E, n)
    t_build = time.perf_counter() - t0
    print(f"graph={args.graph} n={g.n} m={g.m} wedges={g.wedge_count():.3e} "
          f"build {t_build:.2f}s order={args.order} device={device}")

    t0 = time.perf_counter()
    extra = ""
    if args.engine == "pkt":
        res = pkt(g, chunk=args.chunk, mode=args.mode,
                  support_mode=args.support_mode, table_mode=args.table_mode,
                  compact_frac=args.compact_frac or None, device=device)
        truss = res.trussness
        extra = (f"levels={res.levels} sublevels={res.sublevels} "
                 f"compactions={res.compactions}")
    elif args.engine == "trilist":
        truss = truss_trilist(g, device=device)
    elif args.engine == "wc":
        truss = truss_wc(g)
    else:
        truss = truss_ros(g, device=device)
    dt = time.perf_counter() - t0
    gweps = g.wedge_count() / max(dt, 1e-12) / 1e9

    tmax = int(truss.max(initial=2))
    hist = np.bincount(np.asarray(truss, np.int64))
    top = ", ".join(f"{k}:{hist[k]}" for k in np.nonzero(hist)[0][-5:])
    print(f"engine={args.engine} time {dt:.3f}s  GWeps {gweps:.4f}  "
          f"t_max {tmax}  {extra}")
    print(f"largest k-classes: {top}")

    if args.verify:
        ref = truss_numpy(g.El)
        ok = np.array_equal(np.asarray(truss, np.int64), ref)
        print("verify vs oracle:", "OK" if ok else "MISMATCH")
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
