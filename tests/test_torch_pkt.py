"""Port parity: ``repro_torch`` PKT vs the JAX reference, bitwise.

Every peel executor × support executor × table mode × compaction setting
of the port, on the CPU, must equal ``repro.core.pkt.pkt`` (chunked / jnp) in
trussness, initial support, levels, sub-levels and compactions.
"""

import functools
import importlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from repro.core.ref import truss_numpy
from repro.graphs.csr import build_csr as ref_build
from repro.graphs.gen import barabasi_albert_edges, rmat_edges

from repro_torch.graphs.csr import build_csr as port_build

# ``repro.core`` re-exports the ``pkt`` function, which shadows the module
ref_pkt = importlib.import_module("repro.core.pkt")
ref_csr = importlib.import_module("repro.graphs.csr")
port_pkt = importlib.import_module("repro_torch.core.pkt")
port_prep = importlib.import_module("repro_torch.core.prep")


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


GRAPHS = {
    "er": _er(22, 0.35, 1),
    "rmat": rmat_edges(6, edge_factor=5, seed=2),
    "ba": barabasi_albert_edges(30, 3, seed=3),
}
COMPACTION = {
    "off": dict(compact_frac=None),
    "aggressive": dict(compact_frac=0.99, compact_min=0),
}


@functools.lru_cache(maxsize=None)
def _reference(name, compaction):
    return ref_pkt.pkt(ref_build(GRAPHS[name]), mode="chunked",
                       support_mode="jnp", chunk=16, **COMPACTION[compaction])


@functools.lru_cache(maxsize=None)
def _bench(rel):
    """A file of the benchmark (``bench/<rel>``), loaded by path: its
    generators and its plain reference import nothing of either package."""
    path = pathlib.Path(__file__).resolve().parents[1] / "bench" / rel
    name = "bench_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _assert_same(got, want):
    assert got.trussness.dtype == np.int32 and got.support.dtype == np.int32
    assert np.array_equal(got.trussness, want.trussness)
    assert np.array_equal(got.support, want.support)
    assert (got.levels, got.sublevels, got.compactions) == \
        (want.levels, want.sublevels, want.compactions)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("compaction", sorted(COMPACTION))
@pytest.mark.parametrize("mode", ["chunked", "dense", "kernel"])
def test_pkt_matrix_matches_reference(name, compaction, mode):
    want = _reference(name, compaction)
    if compaction == "aggressive":
        assert want.compactions > 0  # the case really compacts
    for support_mode in ("torch", "kernel"):
        for table_mode in ("numpy", "device"):
            got = port_pkt.pkt(port_build(GRAPHS[name]), mode=mode,
                               support_mode=support_mode,
                               table_mode=table_mode, chunk=16,
                               **COMPACTION[compaction], device="cpu")
            _assert_same(got, want)
    assert np.array_equal(want.trussness,
                          truss_numpy(ref_build(GRAPHS[name]).El))


def test_pkt_matches_reference_pallas_executors():
    """One small case against the reference's Pallas executors (interpret)."""
    E = _er(14, 0.45, 4)
    want = ref_pkt.pkt(ref_build(E), mode="pallas", support_mode="pallas",
                       interpret=True)
    got = port_pkt.pkt(port_build(E), device="cpu")
    _assert_same(got, want)


def test_pkt_default_chunk_and_phase_timings():
    E = GRAPHS["rmat"]
    want = ref_pkt.pkt(ref_build(E))
    got = port_pkt.pkt(port_build(E), phase_timings=True, device="cpu")
    _assert_same(got, want)
    assert set(got.phases) >= {"tables", "support", "peel"}
    assert all(v >= 0.0 for v in got.phases.values())


def test_truss_pkt_swapped_and_duplicate_rows():
    E = GRAPHS["er"]
    rng = np.random.default_rng(5)
    rows = np.concatenate([E, E[:7, ::-1], E[3:9]])
    rows = rows[rng.permutation(rows.shape[0])]
    for reorder in (True, False):
        want = ref_pkt.truss_pkt(rows, reorder=reorder)
        got = port_pkt.truss_pkt(rows, reorder=reorder, device="cpu")
        assert got.dtype == np.int64
        assert np.array_equal(got, want), reorder
    assert port_pkt.truss_pkt(np.zeros((0, 2), np.int64),
                              device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="self-loops"):
        port_pkt.truss_pkt(np.array([[1, 1]]), device="cpu")


@pytest.mark.parametrize("mode", ["chunked", "kernel"])
def test_peel_live_subset_with_pinned(mode):
    """A masked re-peel of an edge subset with schedule (pinned) edges, as
    the incremental layer drives it, equals the reference's."""
    E = GRAPHS["ba"]
    g = ref_build(E)
    S0 = ref_pkt.pkt(g).support
    rng = np.random.default_rng(6)
    live = np.sort(rng.choice(g.m, size=g.m // 2, replace=False))
    pinned = rng.random(live.shape[0]) < 0.25
    for kwargs in (dict(), dict(compact_frac=0.99, compact_min=0)):
        want = ref_pkt.peel_live_subset(g.El, live, S0[live], pinned,
                                        mode="chunked", **kwargs)
        got = port_pkt.peel_live_subset(g.El, live, S0[live], pinned,
                                        mode=mode, device="cpu", **kwargs)
        assert np.array_equal(got, want), kwargs
    with pytest.raises(ValueError, match="strictly increasing"):
        port_pkt.peel_live_subset(g.El, live[::-1], S0[live], device="cpu")
    assert port_pkt.peel_live_subset(g.El, live[:0], S0[:0],
                                     device="cpu").shape == (0,)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("compaction", sorted(COMPACTION))
def test_kernel_executor_sparse_update_matches_reference(name, compaction):
    """The kernel executor — a dense update per level, then a fold and a
    sparse update per sub-level — equals the reference exactly in
    trussness, support, levels, sub-levels and compactions, and so does its
    masked re-peel with pinned edges."""
    peel = importlib.import_module("repro_torch.kernels.peel")
    want = _reference(name, compaction)
    before = (peel.UPDATE_COUNTS.plain, peel.DENSE_COUNTS.plain)
    got = port_pkt.pkt(port_build(GRAPHS[name]), chunk=16, device="cpu",
                       **COMPACTION[compaction])
    _assert_same(got, want)
    assert (peel.UPDATE_COUNTS.plain - before[0],
            peel.DENSE_COUNTS.plain - before[1]) == (got.sublevels,
                                                     got.levels)
    g = ref_build(GRAPHS[name])
    rng = np.random.default_rng(8)
    live = np.sort(rng.choice(g.m, size=2 * g.m // 3, replace=False))
    pinned = rng.random(live.shape[0]) < 0.25
    S0 = want.support
    assert np.array_equal(
        port_pkt.peel_live_subset(g.El, live, S0[live], pinned, mode="kernel",
                                  device="cpu", **COMPACTION[compaction]),
        ref_pkt.peel_live_subset(g.El, live, S0[live], pinned,
                                 mode="chunked", **COMPACTION[compaction]))


def test_align_to_input_rejects_missing_edges():
    g = port_build(GRAPHS["er"])
    with pytest.raises(ValueError, match="not present"):
        port_pkt.align_to_input(np.zeros(g.m), g, np.array([[0, 21]]), 22,
                                keys=np.array([10 ** 9]))


def test_invalid_modes_rejected():
    g = port_build(GRAPHS["er"])
    for kwargs in (dict(mode="pallas"), dict(support_mode="jnp"),
                   dict(table_mode="disk")):
        with pytest.raises(ValueError, match="mode"):
            port_pkt.pkt(g, device="cpu", **kwargs)
    # the alias wins over mode, as in the reference
    got = port_pkt.pkt(g, mode="bogus", peel_mode="dense", device="cpu")
    _assert_same(got, ref_pkt.pkt(ref_build(GRAPHS["er"])))


def _refuse_tables(monkeypatch):
    """Make every wedge-table builder of the port raise."""
    sup = importlib.import_module("repro_torch.core.support")

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path built a wedge table")

    for name in ("_build_support_table_dev", "_build_peel_table_dev",
                 "build_support_table", "build_peel_table"):
        monkeypatch.setattr(sup, name, refuse)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("compaction", sorted(COMPACTION))
@pytest.mark.parametrize("table_mode", ["device", "numpy"])
def test_kernel_path_builds_no_table(name, compaction, table_mode,
                                     monkeypatch):
    """The kernel executors read the CSR: with every table builder made to
    raise, pkt, peel_live_subset and the engine still equal the reference."""
    from repro_torch.serve.truss_engine import TrussEngine

    _refuse_tables(monkeypatch)
    want = _reference(name, compaction)
    got = port_pkt.pkt(port_build(GRAPHS[name]), mode="kernel",
                       support_mode="kernel", table_mode=table_mode,
                       chunk=16, device="cpu", **COMPACTION[compaction])
    _assert_same(got, want)
    g = ref_build(GRAPHS[name])
    rng = np.random.default_rng(7)
    live = np.sort(rng.choice(g.m, size=g.m // 2, replace=False))
    pinned = rng.random(live.shape[0]) < 0.25
    S0 = want.support
    assert np.array_equal(
        port_pkt.peel_live_subset(g.El, live, S0[live], pinned, mode="kernel",
                                  table_mode=table_mode, device="cpu",
                                  **COMPACTION[compaction]),
        ref_pkt.peel_live_subset(g.El, live, S0[live], pinned,
                                 mode="chunked", **COMPACTION[compaction]))
    eng = TrussEngine(table_mode=table_mode, device="cpu")
    ticket = eng.submit(GRAPHS[name])
    eng.flush()
    assert np.array_equal(eng.result(ticket),
                          ref_pkt.truss_pkt(GRAPHS[name]))


@pytest.mark.parametrize("phase", ["support", "peel"])
@pytest.mark.parametrize("mode", ["kernel", "chunked"])
def test_table_ceiling_refuses_as_the_reference(mode, phase, monkeypatch):
    """Past the int32 table ceiling the reference refuses the graph, and
    the port refuses it where it would build the table that overflows: the
    support table, or the torch executors' peel table.  The kernel peel
    builds no peel table: past the peel table's ceiling it decomposes the
    graph as the reference does under the normal ceiling, and as the plain
    reference of the benchmark does."""
    ref_support = importlib.import_module("repro.core.support")
    port_support = importlib.import_module("repro_torch.core.support")
    g = port_build(GRAPHS["rmat"])
    want = _reference("rmat", "off")            # under the normal ceiling
    sup_pad = 1 << (port_support.support_table_size(g) - 1).bit_length()
    peel_pad = 1 << (port_support.peel_table_size(g) - 1).bit_length()
    assert peel_pad > sup_pad
    # "peel": the support table fits, the peel table does not
    ceiling = 8 if phase == "support" else sup_pad
    for mod in (ref_support, port_support):
        monkeypatch.setattr(mod, "_MAX_TABLE", ceiling)
    with pytest.raises(ValueError, match="int32"):
        ref_pkt.pkt(ref_build(GRAPHS["rmat"]))

    def run():
        return port_pkt.pkt(g, mode=mode, support_mode=mode.replace(
            "chunked", "torch"), compact_frac=None, device="cpu")

    if (mode, phase) != ("kernel", "peel"):
        with pytest.raises(ValueError, match="int32"):
            run()
        return
    got = run()
    _assert_same(got, want)
    assert np.array_equal(got.trussness,
                          _bench("reference/truss.py").decompose(g.El)
                          .trussness)


def test_kernel_path_refuses_a_work_list_past_int32(monkeypatch):
    """The kernel path's one int32 limit: its frontier work list."""
    monkeypatch.setattr(port_pkt.peel_kernel, "work_capacity",
                        lambda m, rows: 1 << 31)
    with pytest.raises(ValueError, match="work list"):
        port_pkt.pkt(port_build(GRAPHS["er"]), device="cpu")


def _shuffled_rows(E, seed):
    """``E``'s rows in a seeded order, each row's endpoints flipped by a
    coin, and that order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(E.shape[0])
    rows = E[order]
    flip = rng.random(rows.shape[0]) < 0.5
    return np.where(flip[:, None], rows[:, ::-1], rows), order


@pytest.mark.parametrize("entry", ["truss_pkt", "engine"])
def test_kernel_path_accepts_past_the_peel_table_ceiling(entry, monkeypatch):
    """``truss_pkt`` and ``TrussEngine.submit``/``result`` decompose a graph
    whose padded peel table passes the int32 ceiling, which the reference
    refuses; the engine's table executors still refuse it at ``submit``."""
    from repro_torch.serve.truss_engine import TrussEngine

    E = GRAPHS["rmat"]
    rows, order = _shuffled_rows(E, 11)
    port_support = importlib.import_module("repro_torch.core.support")
    g, _, _ = port_prep.preprocess(rows)
    sup_pad = 1 << (port_support.support_table_size(g) - 1).bit_length()
    peel_pad = 1 << (port_support.peel_table_size(g) - 1).bit_length()
    assert peel_pad > sup_pad
    want = ref_pkt.truss_pkt(rows)              # under the normal ceiling
    for mod in (importlib.import_module("repro.core.support"), port_support):
        monkeypatch.setattr(mod, "_MAX_TABLE", sup_pad)
    with pytest.raises(ValueError, match="int32"):
        ref_pkt.truss_pkt(rows)
    if entry == "truss_pkt":
        got = port_pkt.truss_pkt(rows, device="cpu")
    else:
        eng = TrussEngine(device="cpu")
        got = eng.result(eng.submit(rows))
        with pytest.raises(ValueError, match="int32"):
            TrussEngine(mode="chunked", device="cpu").submit(rows)
    assert np.array_equal(got, want)
    truth = _bench("reference/truss.py").decompose(E).trussness
    assert np.array_equal(got, truth[order])


def test_truss_pkt_on_a_graph500_draw_equals_the_plain_reference():
    """A scale-10 draw of the benchmark's Graph500 generator, its rows in a
    seeded order, through ``truss_pkt`` on the CPU."""
    data = _bench("gen/graph500.py").make(
        dict(scale=10, edge_factor=16, a=0.57, b=0.19, c=0.19, d=0.05),
        2**31 + 23)
    E = data["graphs"][0]
    rows, order = _shuffled_rows(data["rows"], 5)
    got = port_pkt.truss_pkt(rows, device="cpu")
    truth = _bench("reference/truss.py").decompose(E).trussness
    assert truth.max() > 4
    assert np.array_equal(got, truth[order])


@pytest.mark.parametrize("compaction", sorted(COMPACTION))
def test_plain_loop_spans_read_once_per_sublevel(compaction):
    """On the CPU the kernel executor's loop runs from the host: each
    ``pkt.loop`` span carries one blocking read per sub-level
    (``host_reads == sublevels``) and the host's wait in them."""
    from repro_torch import trace

    trace.enable()
    try:
        res = port_pkt.pkt(port_build(GRAPHS["rmat"]), device="cpu",
                           **COMPACTION[compaction])
        loops = [sp for sp in trace.spans() if sp.name == "pkt.loop"]
    finally:
        trace.disable()
        trace.clear()
    assert len(loops) == res.compactions + 1
    for sp in loops:
        assert sp.attrs["host_reads"] == sp.attrs["sublevels"]
        assert sp.attrs["wait_ns"] >= 0
    assert sum(sp.attrs["host_reads"] for sp in loops) == res.sublevels


@pytest.mark.parametrize("compaction", sorted(COMPACTION))
def test_count_launches_counts_the_loop_once_per_segment(compaction):
    """``count_launches`` has the fused loop's key; on the CPU its plain
    version runs once per peel segment and the kernel never launches."""
    from repro_torch.kernels import count_launches, peel

    before = peel.LOOP_COUNTS.mine()
    with count_launches() as counted:
        res = port_pkt.pkt(port_build(GRAPHS["er"]), device="cpu",
                           **COMPACTION[compaction])
    after = peel.LOOP_COUNTS.mine()
    assert counted["loop"] == 0
    assert after["kernel"] == before["kernel"]
    assert after["plain"] - before["plain"] == res.compactions + 1
    assert counted["plain"] == (1 + (res.compactions + 1)
                                + 2 * res.sublevels + res.levels)


def _messy_rows(seed):
    """An R-MAT graph and a hub, ids spread with gaps, rows duplicated and
    endpoints swapped, in a seeded order."""
    rng = np.random.default_rng(seed)
    E = rmat_edges(8, edge_factor=6, seed=seed)
    hub = np.stack([np.zeros(60, np.int64),
                    rng.choice(np.arange(1, 256), 60, replace=False)], axis=1)
    R = np.concatenate([E, hub]) * 3 + 5
    R = np.concatenate([R, R[:40, ::-1], R[10:30]])
    flip = rng.random(R.shape[0]) < 0.5
    R = np.where(flip[:, None], R[:, ::-1], R)
    return R[rng.permutation(R.shape[0])]


PREP_ROWS = {
    "messy0": _messy_rows(0),
    "messy1": _messy_rows(1),
    "messy1_int32": _messy_rows(1).astype(np.int32),
    "one_edge": np.array([[7, 3]], np.int64),
    "isolated_max_id": np.array([[0, 1], [1, 2], [2, 0], [999, 4]], np.int64),
    "empty": np.zeros((0, 2), np.int64),
}


def _ref_preprocess(rows, reorder):
    """The JAX package's preprocessing of ``truss_pkt`` on ``rows``: its
    graph, id space and row keys, from ``repro.graphs.csr``'s helpers."""
    E, lo, hi, n = ref_csr.canonical_edges_with_rows(rows)
    if E.size == 0:
        return ref_build(E, 0), 0, np.zeros(0, np.int64)
    if reorder:
        perm = ref_csr.degeneracy_order(E, n)
        E = ref_csr.relabel(E, perm)
        lo, hi = perm[lo], perm[hi]
    keys = ref_csr.edge_keys(np.minimum(lo, hi), np.maximum(lo, hi), n)
    return ref_build(E, n), n, keys


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("name", sorted(PREP_ROWS))
def test_device_preprocess_equals_host(name, reorder):
    """``prep.preprocess_device`` (here on the CPU) equals the JAX
    package's preprocessing field for field, row keys included, and
    ``align_device`` equals its ``align_to_input`` on them."""
    import torch

    rows = PREP_ROWS[name]
    g, n, keys = _ref_preprocess(rows, reorder)
    g2, n2, keys2 = port_prep.preprocess_device(rows, reorder=reorder,
                                                device="cpu")
    assert (g2.n, g2.m, n2) == (g.n, g.m, n)
    for f in ("Es", "N", "Eid", "El", "Eo"):
        a, b = getattr(g, f), getattr(g2, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert keys2.dtype == torch.int64
    got_keys = keys2.numpy()
    assert got_keys.dtype == keys.dtype and np.array_equal(got_keys, keys)
    truss = np.random.default_rng(3).integers(2, 9, g.m).astype(np.int32)
    want = ref_pkt.align_to_input(truss, g, None, n, keys=keys)
    got = port_prep.align_device(truss, g2, n2, keys2, torch.device("cpu"))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["float_dtype", "negative_id", "self_loop",
                                  "huge_id", "bad_shape"])
def test_device_preprocess_rejects_as_host(name):
    """The rows the JAX package's ``check_edge_array`` rejects, with its
    messages."""
    bad = {"float_dtype": np.array([[0.0, 1.0]]),
           "negative_id": np.array([[0, 1], [4, -2], [-1, 2]], np.int64),
           "self_loop": np.array([[0, 1], [3, 3]], np.int64),
           "huge_id": np.array([[0, np.iinfo(np.int32).max]], np.int64),
           "bad_shape": np.array([[0, 1, 2]], np.int64)}[name]
    with pytest.raises(ValueError) as ref:
        ref_csr.check_edge_array(bad)
    with pytest.raises(ValueError) as dev:
        port_prep.preprocess_device(bad, device="cpu")
    assert str(dev.value) == str(ref.value)


def test_align_device_rejects_missing_edges():
    """A key missing from the graph raises the JAX package's
    ``align_to_input`` error, and the keys present align as there."""
    import torch

    g, n, keys = _ref_preprocess(GRAPHS["er"], True)
    g2, n2, keys2 = port_prep.preprocess_device(GRAPHS["er"], device="cpu")
    truss = np.random.default_rng(4).integers(2, 9, g.m).astype(np.int32)
    assert np.array_equal(
        port_prep.align_device(truss, g2, n2, keys2, torch.device("cpu")),
        ref_pkt.align_to_input(truss, g, None, n, keys=keys))
    missing = np.concatenate([keys, [n * n - 1, 10 ** 9]])
    with pytest.raises(ValueError) as ref:
        ref_pkt.align_to_input(truss, g, None, n, keys=missing)
    with pytest.raises(ValueError) as dev:
        port_prep.align_device(truss, g2, n2, torch.from_numpy(missing),
                               torch.device("cpu"))
    assert "not present" in str(dev.value)
    assert str(dev.value) == str(ref.value)


# --- compaction on the device ------------------------------------------------

#: the rules of ``prep.compacts_on_device`` the device-compaction tests run
#: under:
#: every survivor count on the device, or only the larger ones (the
#: first compactions on the device, the later ones on the host)
DEVICE_RULES = {
    "always": lambda m: 0,
    "mixed": lambda m: m // 4,
}


def _device_rule(monkeypatch, rule, m):
    """Make ``prep.compacts_on_device`` choose the device (here the CPU)
    from ``DEVICE_RULES[rule](m)`` survivors; returns that threshold."""
    threshold = DEVICE_RULES[rule](m)
    monkeypatch.setattr(port_prep, "compacts_on_device",
                        lambda rows, device: rows >= threshold)
    return threshold


@pytest.mark.parametrize("pinned", ["none", "live", "dead"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_compaction_equals_host_build(name, pinned):
    """``_make_subproblem_device`` (here on the CPU) equals
    ``_make_subproblem``'s host build of the same survivors field for
    field: the padded CSR, the carried state, the pinned marks (None where
    no survivor is pinned), the output slots and the sizes.  The segment
    starts from a host-built subset problem with pinned marks ("live"),
    without ("none"), or gets marks only on its finished edges ("dead")."""
    import torch

    g = port_build(GRAPHS[name])
    S0 = port_pkt.pkt(g, device="cpu").support
    rng = np.random.default_rng(len(name))
    live = np.sort(rng.choice(g.m, size=3 * g.m // 4, replace=False))
    pin = rng.random(live.shape[0]) < 0.25 if pinned == "live" else None
    kw = dict(chunk_req=None, table_mode="device", mode="kernel",
              device=torch.device("cpu"))
    problem = port_pkt._make_subproblem(g.El[live], live, S0[live], pin,
                                        **kw)
    S_ext, processed, _, _, left = port_pkt._peel_loop(
        problem["N"], problem["Eid"], problem["S_ext0"],
        problem["processed0"], problem["tabs"], m=problem["m"], chunk=None,
        n_chunks=None, iters=problem["iters"], mode="kernel",
        pinned=problem["pinned"], stop_live=live.shape[0] // 2)
    m = problem["m"]
    assert 0 < left == int((~processed[:m]).sum())
    if pinned == "dead":
        problem["pinned"] = processed.clone()
        problem["pinned"][m] = False
        problem["pinned_np"] = problem["pinned"].numpy()
    host_state = (S_ext[:m].numpy(), processed[:m].numpy())
    want = port_pkt._make_subproblem(
        *port_pkt._host_rows(problem, S_ext, processed, host_state), **kw)
    got = port_pkt._make_subproblem_device(problem, S_ext, processed)
    assert (got["m"], got["live"], got["iters"]) == \
        (want["m"], want["live"], want["iters"])
    assert got["live"] == left
    assert (got["tabs"].work_cap, got["tabs"].peel_rows) == \
        (want["tabs"].work_cap, want["tabs"].peel_rows)
    pairs = {f: (got[f], want[f]) for f in ("N", "Eid", "S_ext0",
                                            "processed0")}
    pairs.update({f: (getattr(got["tabs"], f), getattr(want["tabs"], f))
                  for f in ("u", "v", "Es")})
    pairs["ids"] = (got["ids"], torch.from_numpy(want["ids"]))
    for f, (a, b) in pairs.items():
        assert a.dtype == b.dtype and torch.equal(a, b), f
    if pinned == "live":
        assert want["pinned"] is not None
    if pinned == "none" or pinned == "dead":
        assert want["pinned"] is None
    assert (got["pinned"] is None) == (want["pinned"] is None)
    if want["pinned"] is not None:
        assert torch.equal(got["pinned"], want["pinned"])
    # the host build's subproblem reads the host arrays, the device's none
    assert got["El"] is None and got["pinned_np"] is None


@pytest.mark.parametrize("rule", sorted(DEVICE_RULES))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_compaction_matches_reference(name, rule, monkeypatch):
    """``pkt`` with its compactions built on the device (here the CPU,
    ``prep.compacts_on_device`` patched; "mixed": the later, smaller ones
    on the host) equals the reference bitwise: trussness, support, levels,
    sub-levels and compactions.  Each ``pkt.compact`` span says where it
    ran."""
    from repro_torch import trace

    g = port_build(GRAPHS[name])
    threshold = _device_rule(monkeypatch, rule, g.m)
    trace.enable()
    try:
        got = port_pkt.pkt(g, device="cpu", **COMPACTION["aggressive"])
        compacts = [sp for sp in trace.spans() if sp.name == "pkt.compact"]
    finally:
        trace.disable()
        trace.clear()
    _assert_same(got, _reference(name, "aggressive"))
    assert len(compacts) == got.compactions > 0
    for sp in compacts:
        want_on = "cpu" if sp.attrs["m"] >= threshold else "host"
        assert sp.attrs == {"m": sp.attrs["m"], "on": want_on}
    assert compacts[0].attrs["on"] == "cpu"
    if rule == "mixed":
        assert compacts[-1].attrs["on"] == "host"


@pytest.mark.parametrize("rule", sorted(DEVICE_RULES))
def test_peel_live_subset_device_compaction_with_pinned(rule, monkeypatch):
    """The region peel with pinned edges, its subproblem ("always") and its
    later compactions built on the device (here the CPU), equals the
    reference's."""
    E = GRAPHS["ba"]
    g = ref_build(E)
    S0 = ref_pkt.pkt(g).support
    rng = np.random.default_rng(6)
    live = np.sort(rng.choice(g.m, size=g.m // 2, replace=False))
    pinned = rng.random(live.shape[0]) < 0.25
    _device_rule(monkeypatch, rule, live.shape[0])
    kwargs = COMPACTION["aggressive"]
    want = ref_pkt.peel_live_subset(g.El, live, S0[live], pinned,
                                    mode="chunked", **kwargs)
    got = port_pkt.peel_live_subset(g.El, live, S0[live], pinned,
                                    mode="kernel", device="cpu", **kwargs)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_subset_problem_built_on_the_device_equals_host(name, pinned):
    """``peel_live_subset``'s device build (``_device_problem`` over the
    subset's rows, here on the CPU) equals ``_make_subproblem``'s host
    build field for field."""
    import torch

    g = port_build(GRAPHS[name])
    S0 = port_pkt.pkt(g, device="cpu").support
    rng = np.random.default_rng(len(name) + 1)
    live = np.sort(rng.choice(g.m, size=2 * g.m // 3, replace=False))
    pin = rng.random(live.shape[0]) < 0.25 if pinned else None
    k = live.shape[0]
    want = port_pkt._make_subproblem(
        g.El[live], np.arange(k), S0[live], pin, chunk_req=None,
        table_mode="device", mode="kernel", device=torch.device("cpu"))
    rows = torch.from_numpy(g.El[live].astype(np.int64))
    got = port_pkt._device_problem(
        rows[:, 0], rows[:, 1], torch.from_numpy(S0[live]), torch.arange(k),
        None if pin is None else torch.from_numpy(pin), g.n)
    assert (got["m"], got["live"], got["iters"]) == \
        (want["m"], want["live"], want["iters"])
    assert (got["tabs"].work_cap, got["tabs"].peel_rows) == \
        (want["tabs"].work_cap, want["tabs"].peel_rows)
    pairs = {f: (got[f], want[f]) for f in ("N", "Eid", "S_ext0",
                                            "processed0")}
    pairs.update({f: (getattr(got["tabs"], f), getattr(want["tabs"], f))
                  for f in ("u", "v", "Es")})
    pairs["ids"] = (got["ids"], torch.from_numpy(want["ids"]))
    for f, (a, b) in pairs.items():
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert (got["pinned"] is None) == (want["pinned"] is None) == \
        (not pinned)
    if pinned:
        assert torch.equal(got["pinned"], want["pinned"])
