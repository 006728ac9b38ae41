"""Truss decomposition CLI of the port — the pipeline end to end.

  PYTHONPATH=src python -m repro_torch.launch.truss --graph rmat-small \
      [--order kco|natural] [--engine pkt|dist|trilist|wc|ros] [--verify] \
      [--device cuda|cpu]

Loads a named graph, relabels it by degeneracy order (``--order kco``),
builds the CSR graph and decomposes it with one engine: PKT (``pkt``, with
its executors), distributed PKT (``dist``: ``core/pkt_dist.py`` over the
initialized ``torch.distributed`` group, or one rank), the triangle-list
peel (``trilist``), or the paper's baselines WC (``wc``, a host loop) and
Ros (``ros``, support on the device).  It prints the same summary lines as the JAX package's CLI;
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
      [--insert-mode batched|sequential|klevel] [--verify]

Community serving (DESIGN.md §11): build the triangle-connected k-truss
community index on the handle and answer queries at level k; ``--verify``
checks every level's labels bitwise against the other builder (device
flood vs host union-find).  Composes with ``--update-stream`` (the index is
queried on the post-churn graph, having survived the updates):

  PYTHONPATH=src python -m repro_torch.launch.truss --graph rmat-small \
      --query-communities 4 [--hier-mode device|host] [--verify]

Async serving (DESIGN.md §12, §15): replay N paced requests in the 90/9/1
query/update/open mix through ``TrussScheduler``, optionally under seeded
dispatch faults and per-request deadlines; ``--verify`` replays the same
schedule synchronously and checks every completed result bitwise:

  PYTHONPATH=src python -m repro_torch.launch.truss --graph rmat-small \
      --serve 120 --qps 300 [--fault-rate 0.1 --deadline-ms 250] [--verify]
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np

from repro_torch.core import (pkt, pkt_dist, truss_numpy, truss_pkt,
                              truss_ros, truss_trilist, truss_wc)
from repro_torch.core.hierarchy import HIER_MODES
from repro_torch.core.pkt import PEEL_MODES
from repro_torch.core.truss_inc import INSERT_MODES
from repro_torch.core.support import SUPPORT_MODES, TABLE_MODES
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.prep import order_and_build
from repro_torch.graphs.datasets import named_graph
from repro_torch.graphs.gen import erdos_renyi_edges
from repro_torch.kernels.wedge_common import pow2_chunk
from repro_torch.serve.truss_engine import TrussEngine

ENGINES = ("pkt", "dist", "trilist", "wc", "ros")


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
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="replay N mixed 90/9/1 query/update/open requests "
                         "through the async TrussScheduler (DESIGN.md §12)")
    ap.add_argument("--qps", type=float, default=200.0,
                    help="offered request rate for --serve")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="scheduler bucket size before dispatch (--serve)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="scheduler latency bound: a non-full bucket "
                         "dispatches once its oldest request waits this "
                         "long (--serve)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject seeded dispatch faults at this rate during "
                         "--serve (DESIGN.md §15); completed requests stay "
                         "parity-checked under --verify")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for --serve; expired "
                         "requests fail with a typed DeadlineExceeded")
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


def serve_schedule(E: np.ndarray, n_ops: int, seed: int):
    """The seeded ``--serve`` replay: ``(pool, ops)``.

    ``pool`` is 32 absent edges the updates toggle (disjoint from the base
    rows the queries sample, so both replays stay valid); ``ops`` holds
    ``n_ops`` requests in the 90/9/1 mix — ``("query", rows)``,
    ``("update", add, remove)`` and ``("open", edges)`` of a small fresh
    graph.  The draws are the JAX package's, in its order.
    """
    n = int(E.max()) + 1
    rng = np.random.default_rng(seed)
    present = {(int(u), int(v)) for u, v in E}
    pool = []
    while len(pool) < 32:
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u != v and (min(u, v), max(u, v)) not in present:
            pool.append((min(u, v), max(u, v)))
            present.add(pool[-1])
    # generation tracks pool presence so removals always hit present edges
    ops, in_pool, n_open = [], set(), 0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.90:
            ops.append(("query", E[rng.integers(0, E.shape[0], size=8)]))
        elif r < 0.99:
            picks = [pool[j] for j in rng.choice(len(pool), size=4,
                                                 replace=False)]
            add = [e for e in picks if e not in in_pool]
            rem = [e for e in picks if e in in_pool]
            in_pool |= set(add)
            in_pool -= set(rem)
            ops.append(("update", np.array(add or np.zeros((0, 2)), np.int64),
                        np.array(rem or np.zeros((0, 2)), np.int64)))
        else:
            ops.append(("open", erdos_renyi_edges(
                64, 8.0, seed=seed + 5000 + n_open)))
            n_open += 1
    return pool, ops


def replay(sched, h, ops, qps: float) -> tuple:
    """Submit ``ops`` against handle ``h`` paced at ``qps``; returns
    ``(outcomes, latencies, seconds)``: per op ``("ok", value)`` or
    ``("failed", exception)``, and ``(kind, seconds)`` per completion."""
    lat, futs = [], []
    t_start = time.perf_counter()
    for i, op in enumerate(ops):
        target = t_start + i / qps
        if target > time.perf_counter():
            time.sleep(target - time.perf_counter())
        t_enq = time.perf_counter()
        if op[0] == "query":
            f = sched.query_async(h, op[1])
        elif op[0] == "update":
            f = sched.update_async(h, add_edges=op[1], remove_edges=op[2])
        else:
            f = sched.open_async(op[1])
        f.add_done_callback(lambda f, k=op[0], t=t_enq:
                            lat.append((k, time.perf_counter() - t)))
        futs.append(f)
    outcomes = []
    for f in futs:
        try:
            outcomes.append(("ok", f.result()))
        except Exception as e:  # noqa: BLE001 — typed, classified by callers
            outcomes.append(("failed", e))
    return outcomes, lat, time.perf_counter() - t_start


def latency_summary(lat) -> dict:
    """Per request kind in ``lat`` (``(kind, seconds)`` pairs): ``n`` and
    the ``p50_ms``/``p99_ms``/``max_ms`` of its latencies, in milliseconds
    (the p-th percentile is the sorted sample at index ``p·n``, the last
    one at most)."""
    out = {}
    for kind in sorted({k for k, _ in lat}):
        ms = sorted(1e3 * s for k, s in lat if k == kind)
        out[kind] = dict(n=len(ms), p50_ms=ms[len(ms) // 2],
                         p99_ms=ms[min(len(ms) - 1, int(0.99 * len(ms)))],
                         max_ms=ms[-1])
    return out


def sync_replay(eng: TrussEngine, E: np.ndarray, ops, outcomes, h, *,
                local_frac: float) -> bool:
    """Replay ``ops`` synchronously on a fresh handle of ``eng``; True when
    every completed result and the final trussness are bitwise equal.
    Failed ops are masked: their updates never committed."""
    hs = eng.open(E, local_frac=local_frac)
    ok = True
    for op, (status, got) in zip(ops, outcomes):
        if status != "ok":
            continue
        if op[0] == "query":
            ok = ok and np.array_equal(got, hs.query(op[1]))
        elif op[0] == "update":
            eng.update(hs, add_edges=op[1], remove_edges=op[2])
        else:
            ok = ok and np.array_equal(got.trussness,
                                       eng.open(op[1]).trussness)
    return ok and np.array_equal(h.trussness, hs.trussness)


def run_serve(args, device) -> None:
    """Replay paced mixed traffic through the async scheduler (``--serve``).

    Opens the named graph as a persistent handle, then replays ``--serve``
    requests at ``--qps`` in the 90/9/1 query/update/open serving mix
    (DESIGN.md §12): trussness queries on base rows, churn updates toggling
    a reserved extra-edge pool (so queried rows always exist), and opens of
    small fresh graphs.  Prints per-kind latency and the scheduler's stage
    breakdown; ``--verify`` replays the same schedule through a synchronous
    engine and checks every result bitwise.

    With ``--fault-rate`` a seeded ``FaultPlan`` injects dispatch faults
    during the replay (DESIGN.md §15): completed requests stay bitwise
    parity-checked, failed ones are masked from the sync replay (their
    updates never committed — commit is batch-scoped).
    """
    from repro_torch.serve import DeadlineExceeded, TrussScheduler
    from repro_torch.testing.chaos import FaultPlan, InjectedFault

    E = named_graph(args.graph)
    n = int(E.max()) + 1
    _, ops = serve_schedule(E, args.serve, args.update_seed)
    # a replay measures latency, not shedding: admit the whole schedule
    sched = TrussScheduler(
        max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
        max_queue=max(256, 4 * args.serve),
        max_inflight=max(64, 4 * args.serve),
        deadline_ms=args.deadline_ms,
        mode=args.mode, support_mode=args.support_mode,
        table_mode=args.table_mode, hier_mode=args.hier_mode,
        insert_mode=args.insert_mode,
        chunk=args.chunk, device=device)
    t0 = time.perf_counter()
    h = sched.open_async(E, local_frac=args.local_frac).result()
    print(f"graph={args.graph} n={n} m={h.m} open "
          f"{time.perf_counter() - t0:.3f}s qps={args.qps} "
          f"mix=90/9/1 query/update/open fault_rate={args.fault_rate} "
          f"device={device}")

    plan = None
    if args.fault_rate > 0.0:
        plan = FaultPlan.uniform(args.fault_rate, seed=args.update_seed)
    with plan if plan is not None else contextlib.nullcontext():
        outcomes, lat, duration = replay(sched, h, ops, args.qps)
    st = sched.stats()
    sched.close()

    summary = latency_summary(lat)
    for kind in ("query", "update", "open"):
        if kind in summary:
            q = summary[kind]
            print(f"{kind:6s} n={q['n']:4d} p50={q['p50_ms']:.2f}ms "
                  f"p99={q['p99_ms']:.2f}ms max={q['max_ms']:.2f}ms")
    print(f"achieved {len(ops) / duration:.0f} qps "
          f"(offered {args.qps:.0f}); dispatches="
          f"{st['counters']['dispatches']} "
          f"coalesced_updates={st['counters']['coalesced_updates']} "
          f"shed={st['counters']['shed']}")
    for stage, s in st["stages"].items():
        if s["count"]:
            print(f"  stage {stage:10s} n={s['count']:4d} "
                  f"total={s['seconds'] * 1e3:.1f}ms "
                  f"max={s['max_seconds'] * 1e3:.1f}ms")

    n_ok = sum(1 for s, _ in outcomes if s == "ok")
    if plan is not None or args.deadline_ms:
        fails = [e for s, e in outcomes if s == "failed"]
        n_inj = sum(isinstance(e, InjectedFault) for e in fails)
        n_dead = sum(isinstance(e, DeadlineExceeded) for e in fails)
        inj = dict(plan.stats()["injected"]) if plan is not None else {}
        print(f"chaos: availability {n_ok}/{len(ops)} "
              f"({n_ok / max(1, len(ops)):.3f}) injected={inj} "
              f"failed: injected={n_inj} deadline={n_dead} "
              f"other={len(fails) - n_inj - n_dead}")
        print(f"  retries={st['counters']['retries']} "
              f"heals={st['counters']['heals']} "
              f"deadline_exceeded={st['counters']['deadline_exceeded']} "
              f"rungs=" +
              ", ".join(f"{site}:{r['rung']}"
                        for site, r in st["resilience"].items()))

    if args.verify:
        eng = TrussEngine(mode=args.mode, support_mode=args.support_mode,
                          table_mode=args.table_mode,
                          hier_mode=args.hier_mode, chunk=args.chunk,
                          device=device)
        ok = sync_replay(eng, E, ops, outcomes, h,
                         local_frac=args.local_frac)
        print("verify async vs sync engine (failed ops masked):",
              "OK" if ok else "MISMATCH")
        if not ok:
            raise SystemExit(1)


def main(argv=None) -> None:
    """Run one decomposition (or an update stream, community queries or a
    serving replay) and print its summary; exit 1 on a mismatch."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.serve:
        return run_serve(args, device)
    if args.update_stream:
        return run_update_stream(args, device)
    if args.query_communities:
        return run_query_communities(args, device)

    E = named_graph(args.graph)
    n = int(E.max()) + 1
    t0 = time.perf_counter()
    g, _ = order_and_build(E, E[:, 0], E[:, 1], n,
                           reorder=args.order == "kco")
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
    elif args.engine == "dist":
        truss = pkt_dist(g, chunk=pow2_chunk(1 << 12,
                                             args.chunk or (1 << 12)),
                         support_mode=args.support_mode,
                         table_mode=args.table_mode, device=device)
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
