"""Truss decomposition CLI of the port — the pipeline end to end.

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

Streaming replay (incremental maintenance, DESIGN.md §9): open the graph as
a persistent engine handle and replay K churn batches through
``TrussEngine.update``, reporting local-vs-full repair decisions and
timings; ``--verify`` checks the final state against the port's
from-scratch ``truss_pkt``:

  PYTHONPATH=src python -m repro_torch.launch.truss --graph rmat-small \
      --update-stream 16 --churn 0.01 \
      [--insert-mode batched|sequential] [--verify]

Community serving (DESIGN.md §11): build the triangle-connected k-truss
community index on the handle and answer queries at level k; ``--verify``
checks every level's labels bitwise against the other builder (device
flood vs host union-find).  Composes with ``--update-stream`` (the index is
queried on the post-churn graph, having survived the updates):

  PYTHONPATH=src python -m repro_torch.launch.truss --graph rmat-small \
      --query-communities 4 [--hier-mode device|host] [--verify]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (pkt, truss_numpy, truss_pkt, truss_ros,
                              truss_trilist, truss_wc)
from repro_torch.core.hierarchy import HIER_MODES
from repro_torch.core.pkt import PEEL_MODES
from repro_torch.core.truss_inc import INSERT_MODES
from repro_torch.core.support import SUPPORT_MODES, TABLE_MODES
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.graphs.csr import build_csr, degeneracy_order, relabel
from repro_torch.graphs.datasets import named_graph
from repro_torch.serve.truss_engine import TrussEngine

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
                    help="check against the numpy oracle (small graphs!); "
                         "with --update-stream against a from-scratch "
                         "truss_pkt, with --query-communities against the "
                         "other index builder")
    ap.add_argument("--update-stream", type=int, default=0, metavar="K",
                    help="replay K incremental churn batches through "
                         "TrussEngine.update instead of one decomposition")
    ap.add_argument("--insert-mode", default="batched",
                    choices=list(INSERT_MODES),
                    help="insertion repair strategy for handle updates: one "
                         "merged-region re-peel per batch (default) or the "
                         "one-at-a-time parity oracle (DESIGN.md §13)")
    ap.add_argument("--churn", type=float, default=0.01,
                    help="fraction of edges swapped per update batch")
    ap.add_argument("--local-frac", type=float, default=0.25,
                    help="affected-region fraction above which an update "
                         "falls back to full recompute")
    ap.add_argument("--update-seed", type=int, default=0)
    ap.add_argument("--query-communities", type=int, default=0, metavar="K",
                    help="build the truss community index and report the "
                         "K-truss communities (DESIGN.md §11); composes "
                         "with --update-stream")
    ap.add_argument("--hier-mode", default="device",
                    choices=list(HIER_MODES),
                    help="community-index builder: the device label flood "
                         "(default) or the host union-find parity oracle")
    return ap.parse_args(argv)


def churn_batch(edges: np.ndarray, n: int, frac: float, rng):
    """One synthetic update batch: remove ``frac·m`` existing edges and add
    the same number of random absent edges (vertex space preserved)."""
    m = edges.shape[0]
    k = max(1, int(round(frac * m)))
    rm = edges[rng.choice(m, size=min(k, m), replace=False)]
    present = set(map(tuple, edges.tolist()))
    add = []
    tries = 0
    while len(add) < k and tries < 100 * k + 1000:  # dense graphs: give up
        tries += 1
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u == v:
            continue
        e = (min(u, v), max(u, v))
        if e not in present:
            present.add(e)
            add.append(e)
    if not add:
        return np.zeros((0, 2), np.int64), rm
    return np.asarray(add, np.int64), rm


def report_communities(handle, k: int, *, verify: bool = False) -> None:
    """Build the community index on ``handle`` and report level-``k`` stats.

    Prints the index-build cost, the level-k community size spectrum and a
    sampled per-query latency; with ``verify`` every level's labels are
    checked bitwise against the other builder.  Exits 1 on a mismatch.
    """
    t0 = time.perf_counter()
    hier = handle.hierarchy().build_all()
    t_build = time.perf_counter() - t0
    comms = handle.communities(k)
    sizes = sorted((c.shape[0] for c in comms), reverse=True)
    E = handle.edges                    # hoisted: El copies stay untimed
    t0 = time.perf_counter()
    n_q = 0
    for eid in range(0, handle.m, max(1, handle.m // 64)):
        handle.community(tuple(E[eid]), k)
        n_q += 1
    t_query = (time.perf_counter() - t0) / max(1, n_q)
    print(f"community index: k_max={hier.k_max} "
          f"levels={len(list(hier.levels))} build {t_build * 1e3:.1f}ms "
          f"({hier.stats}) flood_rounds={hier.flood_rounds}")
    print(f"k={k}: {len(comms)} communities, edge sizes top5={sizes[:5]}, "
          f"query {t_query * 1e6:.0f}us/edge")
    if verify:
        other = "host" if hier.mode == "device" else "device"
        oracle = handle.hierarchy(mode=other).build_all()
        ok = all(np.array_equal(hier.level_labels(kk), oracle.level_labels(kk))
                 for kk in hier.levels)
        print(f"verify {hier.mode} labels vs {other} builder:",
              "OK" if ok else "MISMATCH")
        if not ok:
            raise SystemExit(1)


def _engine(args, device) -> TrussEngine:
    return TrussEngine(mode=args.mode, support_mode=args.support_mode,
                       table_mode=args.table_mode, hier_mode=args.hier_mode,
                       insert_mode=args.insert_mode, chunk=args.chunk,
                       device=device)


def run_update_stream(args, device) -> None:
    """Replay ``--update-stream`` churn batches through an engine handle."""
    E = named_graph(args.graph)
    n = int(E.max()) + 1
    eng = _engine(args, device)
    t0 = time.perf_counter()
    h = eng.open(E, local_frac=args.local_frac)
    t_open = time.perf_counter() - t0
    print(f"graph={args.graph} n={n} m={h.m} open {t_open:.3f}s "
          f"mode={args.mode} sup={args.support_mode} "
          f"insert={args.insert_mode} device={device}")
    if args.query_communities:
        # build the index up front so the stream exercises its survival
        # (local repairs remap untouched levels, dirty the rest)
        h.hierarchy().build_all()

    rng = np.random.default_rng(args.update_seed)
    for i in range(args.update_stream):
        add, rm = churn_batch(h.edges, n, args.churn, rng)
        st = eng.update(h, add_edges=add, remove_edges=rm)
        print(f"batch {i:3d}: +{st.inserted} -{st.deleted} -> m={st.m_after} "
              f"repair={st.mode} affected={st.affected} "
              f"boundary={st.boundary} changed={st.changed} "
              f"{st.seconds * 1e3:.1f}ms")

    s = eng.stats
    mean_ms = 1e3 * s["update_seconds"] / max(1, s["updates"])
    print(f"stream done: {s['updates']} updates "
          f"({s['updates_local']} local / {s['updates_full']} full), "
          f"mean {mean_ms:.1f}ms vs open {t_open * 1e3:.1f}ms")

    if args.query_communities:
        report_communities(h, args.query_communities, verify=args.verify)

    if args.verify:
        ok = np.array_equal(h.trussness, truss_pkt(h.edges, device=device))
        print("verify vs from-scratch pkt:", "OK" if ok else "MISMATCH")
        if not ok:
            raise SystemExit(1)


def run_query_communities(args, device) -> None:
    """Open the graph as a serving handle and answer community queries."""
    E = named_graph(args.graph)
    eng = _engine(args, device)
    t0 = time.perf_counter()
    h = eng.open(E)
    t_open = time.perf_counter() - t0
    print(f"graph={args.graph} n={h.n} m={h.m} open {t_open:.3f}s "
          f"hier_mode={args.hier_mode} device={device}")
    report_communities(h, args.query_communities, verify=args.verify)


def main(argv=None) -> None:
    """Run one decomposition (or an update stream, or community queries)
    and print its summary; exit 1 on a mismatch."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.update_stream:
        return run_update_stream(args, device)
    if args.query_communities:
        return run_query_communities(args, device)

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
