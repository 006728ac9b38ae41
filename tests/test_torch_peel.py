"""Port parity: K2's and the sub-level update's plain versions vs the JAX
package, and edge cases.

States are taken mid-run from the JAX reference's own peel (its compaction
early exit stops the level loop at a level boundary), then fed with the
same numpy values to ``repro.kernels.peel.peel_decrement_fold`` in
interpret mode (over its table, with its own active-chunk mask) and to
``repro_torch.kernels.peel.peel_decrement_fold`` on CPU tensors (its plain
version, over the frontier's work list and the CSR).  The update is held
against the reference's sub-level formula on the same states: the dense
update at a level's start, the sparse update after each fold.  Comparisons
are exact on ``[:m]``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.support as ref_support
from repro.core.ref import truss_numpy
from repro.graphs.csr import build_csr as ref_build
from repro.graphs.gen import barabasi_albert_edges, rmat_edges
from repro.kernels.peel import peel_decrement_fold as ref_fold

from repro_torch.graphs.csr import build_csr as port_build
from repro_torch.kernels import peel as port_kernel

# ``repro.core`` re-exports the ``pkt`` function, which shadows the module
ref_pkt = importlib.import_module("repro.core.pkt")
port_pkt = importlib.import_module("repro_torch.core.pkt")

SENT = 1 << 30


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def _reference_states(E, chunk):
    """(tabs, chunk, n_chunks, g, [(S_ext, processed)]) at level boundaries
    of the reference peel: the start, and after ~1/4, 1/2, 3/4 of the edges
    have retired."""
    g = ref_build(E)
    m = g.m
    tabs, chunk, n_chunks = ref_pkt.prepare_peel(
        ref_support.build_peel_table(g), m, chunk)
    S0 = ref_support.compute_support(g)
    iters = ref_support._search_iters(g)
    states = []
    for frac in (1.0, 0.75, 0.5, 0.25):
        S_ext0 = jnp.asarray(np.append(S0, SENT).astype(np.int32))
        proc0 = jnp.asarray(np.append(np.zeros(m, bool), True))
        S_ext, proc, _, _ = ref_pkt._peel_segment_jit(
            jnp.asarray(g.N), jnp.asarray(g.Eid), S_ext0, proc0,
            jnp.int32(int(frac * m)), None, tabs, m=m, chunk=chunk,
            n_chunks=n_chunks, iters=iters, mode="chunked", interpret=True)
        states.append((np.asarray(S_ext), np.asarray(proc)))
    return g, tabs, chunk, n_chunks, iters, states


def _frontier(S_ext, proc, m):
    alive = np.where(proc, SENT, S_ext)
    l = int(alive.min())
    curr = ~proc & (S_ext == l)
    curr[m] = False
    return l, curr


def _work_list(g, curr, rng=None):
    """The port's work list for the frontier ``curr`` (shuffled with
    ``rng``), as CPU tensors ``(work_e, work_j, counts)``."""
    m = g.m
    front = np.nonzero(curr[:m])[0].astype(np.int32)
    if rng is not None:
        front = rng.permutation(front)
    u, v, Es = (torch.tensor(a) for a in (g.El[:, 0], g.El[:, 1], g.Es))
    cap = port_kernel.work_capacity(m, int(np.minimum(
        g.degrees[g.El[:, 0]], g.degrees[g.El[:, 1]]).sum()))
    work_e = torch.full((cap,), -1, dtype=torch.int32)
    work_j = torch.full((cap,), -1, dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int32)
    port_kernel.frontier_work(torch.tensor(front), u, v, Es, work_e, work_j,
                              counts)
    return work_e, work_j, counts


def _both(g, tabs, chunk, n_chunks, iters, S_ext, proc, curr, l, pinned,
          rng=None, return_touched=False):
    """K2 against the reference at one state → ``dec`` (and the touched
    list when ``return_touched``); ``rng`` shuffles the port's frontier
    list."""
    m = g.m
    active = np.asarray(ref_pkt._active_chunk_mask(
        jnp.asarray(curr), tabs, m, n_chunks))
    want = ref_fold(
        jnp.asarray(active.astype(np.int32)), jnp.full((1,), l, jnp.int32),
        tabs.e1, tabs.cand_slot, tabs.lo, tabs.hi, jnp.asarray(g.N),
        jnp.asarray(g.Eid), jnp.asarray(S_ext),
        jnp.asarray(proc.astype(np.int32)), jnp.asarray(curr.astype(np.int32)),
        jnp.asarray((np.zeros(m + 1, bool) if pinned is None
                     else pinned).astype(np.int32)),
        chunk=chunk, n_chunks=n_chunks, iters=iters, m=m, interpret=True)
    t = torch.tensor
    work_e, work_j, counts = _work_list(g, curr, rng)
    got, touched = port_kernel.peel_decrement_fold(
        work_e, work_j, counts, t(np.array([l], np.int32)), t(g.El[:, 0]),
        t(g.El[:, 1]), t(g.Es), t(g.N), t(g.Eid), t(S_ext), t(proc),
        t(curr), None if pinned is None else t(pinned), m=m)
    assert got.dtype == torch.int32 and got.shape == (m + 1,)
    assert touched.dtype == torch.int32 and touched.shape == (m,)
    assert np.array_equal(got.numpy()[:m], np.asarray(want)[:m])
    assert int(got[m]) == 0
    if return_touched:
        return got.numpy(), touched[:int(counts[3])].numpy()
    return got.numpy()


CASES = {
    "er": (_er(30, 0.3, 7), 16),
    "rmat": (rmat_edges(6, edge_factor=5, seed=9), 64),
    "ba": (barabasi_albert_edges(40, 4, seed=2), 8),
}


@pytest.mark.parametrize("work_slice", [None, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k2_matches_pallas_on_reference_states(name, work_slice,
                                                     monkeypatch):
    """K2's plain version equals the Pallas kernel; ``work_slice=3`` splits
    every edge with more than 3 candidates over several work items, as the
    hubs of a large graph are split."""
    if work_slice is not None:
        monkeypatch.setattr(port_kernel, "WORK_SLICE", work_slice)
    E, chunk = CASES[name]
    g, tabs, chunk, n_chunks, iters, states = _reference_states(E, chunk)
    m = g.m
    rng = np.random.default_rng(len(name))
    checked = 0
    for S_ext, proc in states:
        if proc[:m].all():
            continue
        l, curr = _frontier(S_ext, proc, m)
        pinned = np.append(~proc[:m] & (rng.random(m) < 0.3), False)
        # the frontier in edge order, with pinned edges, and shuffled
        for pin, order in ((None, None), (pinned, None), (None, rng)):
            dec = _both(g, tabs, chunk, n_chunks, iters, S_ext, proc, curr,
                        l, pin, order)
            checked += 1
        # the next sub-level of the same level, from the reference update
        upd = ~proc & ~curr & (dec > 0)
        S2 = np.where(upd, np.maximum(S_ext - dec, l), S_ext).astype(np.int32)
        proc2 = proc | curr
        curr2 = ~proc2 & (S2 == l)
        curr2[m] = False
        if curr2.any():
            _both(g, tabs, chunk, n_chunks, iters, S2, proc2, curr2, l, None)
            checked += 1
    assert checked >= 6


def test_plain_k2_counts_plain_calls_only():
    E, chunk = CASES["er"]
    g, tabs, chunk, n_chunks, iters, states = _reference_states(E, chunk)
    S_ext, proc = states[0]
    l, curr = _frontier(S_ext, proc, g.m)
    before = port_kernel.COUNTS.as_dict()
    _both(g, tabs, chunk, n_chunks, iters, S_ext, proc, curr, l, None)
    after = port_kernel.COUNTS.as_dict()
    assert after["plain"] == before["plain"] + 1
    assert after["kernel"] == before["kernel"]


@pytest.mark.parametrize("work_slice", [None, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_fold_touched_list_is_nonzero_dec(name, work_slice,
                                                 monkeypatch):
    """The plain fold lists the edges it decrements as ``nonzero(dec)`` in
    ascending order, with their number in ``counts[3]``; pinned edges and
    slot ``m`` are never listed."""
    if work_slice is not None:
        monkeypatch.setattr(port_kernel, "WORK_SLICE", work_slice)
    E, chunk = CASES[name]
    g, tabs, chunk, n_chunks, iters, states = _reference_states(E, chunk)
    m = g.m
    rng = np.random.default_rng(len(name) + 1)
    listed = 0
    for S_ext, proc in states:
        if proc[:m].all():
            continue
        l, curr = _frontier(S_ext, proc, m)
        pinned = np.append(~proc[:m] & (rng.random(m) < 0.3), False)
        for pin, order in ((None, None), (pinned, None), (None, rng)):
            dec, touched = _both(g, tabs, chunk, n_chunks, iters, S_ext, proc,
                                 curr, l, pin, order, return_touched=True)
            assert np.array_equal(touched, np.nonzero(dec[:m])[0])
            assert not (proc[touched] | curr[touched]).any()
            assert (S_ext[touched] > l).all()
            if pin is not None:
                assert not pin[touched].any()
            listed += touched.size
    assert listed > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_sublevel_update_matches_reference_formula(name, monkeypatch):
    """The plain updates apply the reference's sub-level body
    (src/repro/core/pkt.py, ``sublevel``) on the reference's own states.
    At a level's start the dense update (zero dec, empty frontier) forms the
    level's first frontier.  After each fold, the sparse update, fed the
    fold's touched list and the old frontier's id list only, gives the
    reference's state and the next frontier's id and work lists and counts,
    and zeroes dec."""
    monkeypatch.setattr(port_kernel, "WORK_SLICE", 4)
    E, chunk = CASES[name]
    g, tabs, chunk, n_chunks, iters, states = _reference_states(E, chunk)
    m = g.m
    t = torch.tensor
    u, v, Es = t(g.El[:, 0]), t(g.El[:, 1]), t(g.Es)
    scan = np.minimum(g.degrees[g.El[:, 0]], g.degrees[g.El[:, 1]])
    buf = port_kernel.buffers(m, port_kernel.work_capacity(m, int(scan.sum())),
                              "cpu")

    def check(p, S, P, C, S_want, P_want, C_want):
        n_items, n_front, n_done, n_touched = buf.counts[p].tolist()
        assert np.array_equal(S.numpy(), S_want)
        assert np.array_equal(P.numpy(), P_want)
        assert np.array_equal(C.numpy(), C_want)
        assert not buf.dec.any()  # dec is zeroed for the next fold
        assert (n_front, n_done, n_touched) == (int(C_want.sum()),
                                                int(P_want.sum()), 0)
        assert np.array_equal(buf.front[p, :n_front].numpy(),
                              np.nonzero(C_want)[0])
        got = sorted(zip(buf.work_e[:n_items].tolist(),
                         buf.work_j[:n_items].tolist()))
        want = sorted((int(e), j) for e in np.nonzero(C_want)[0]
                      for j in range(-(-int(scan[e]) // 4)))
        assert got == want

    checked = 0
    for S_ext, proc in states:
        if proc[:m].all():
            continue
        l, curr = _frontier(S_ext, proc, m)
        lt = t(np.array([l], np.int32))
        S, P = t(S_ext.copy()), t(proc.copy())
        C = torch.zeros(m + 1, dtype=torch.bool)
        buf.dec.zero_()
        # a level's start: zero dec, empty frontier
        port_kernel.dense_update(buf.dec, S, P, C, lt, u, v, Es, buf.front[0],
                                 buf.work_e, buf.work_j, buf.counts[0], m=m)
        check(0, S, P, C, S_ext, proc, curr)
        p = 0
        # the level's sub-levels (up to three), against the reference's
        # formula
        for _ in range(3):
            dec = _both(g, tabs, chunk, n_chunks, iters, S_ext, proc, curr,
                        l, None)
            port_kernel.peel_decrement_fold(
                buf.work_e, buf.work_j, buf.counts[p], lt, u, v, Es, t(g.N),
                t(g.Eid), S, P, C, m=m, dec=buf.dec, touched=buf.touched)
            assert np.array_equal(buf.dec.numpy(), dec)
            upd = ~proc & ~curr & (dec > 0)
            S2 = np.where(upd, np.maximum(S_ext - dec, l),
                          S_ext).astype(np.int32)
            proc2 = proc | curr
            curr2 = ~proc2 & (S2 == l)
            curr2[m] = False
            port_kernel.sublevel_update(
                buf.dec, S, P, C, lt, u, v, Es, buf.touched, buf.front[p],
                buf.counts[p], buf.front[1 - p], buf.work_e, buf.work_j,
                buf.counts[1 - p], m=m)
            p = 1 - p
            check(p, S, P, C, S2, proc2, curr2)
            checked += 1
            S_ext, proc, curr = S2, proc2, curr2
            if not curr.any():
                break
    assert checked >= 3


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_peel_loop_segments_match_reference(name, pinned):
    """The fused loop's plain version (``peel_loop`` on CPU tensors) from
    the reference's own states, with several ``stop_live`` values: each
    segment ends where the reference's segment ends, with its state, levels
    and sub-levels; one host read per sub-level."""
    E, chunk = CASES[name]
    g, tabs, chunk, n_chunks, iters, states = _reference_states(E, chunk)
    m = g.m
    t = torch.tensor
    u, v, Es, N, Eid = (t(a) for a in (g.El[:, 0], g.El[:, 1], g.Es, g.N,
                                       g.Eid))
    scan = np.minimum(g.degrees[g.El[:, 0]], g.degrees[g.El[:, 1]])
    cap = port_kernel.work_capacity(m, int(scan.sum()))
    rng = np.random.default_rng(len(name) + 2)
    segments = 0
    for S_ext, proc in states[:2]:
        pin = (np.append(~proc[:m] & (rng.random(m) < 0.3), False)
               if pinned else None)
        for frac in (0.6, 0.3, 0.0):
            stop = int(frac * m)
            want_S, want_P, want_lv, want_sb = ref_pkt._peel_segment_jit(
                jnp.asarray(g.N), jnp.asarray(g.Eid), jnp.asarray(S_ext),
                jnp.asarray(proc), jnp.int32(stop),
                None if pin is None else jnp.asarray(pin), tabs, m=m,
                chunk=chunk, n_chunks=n_chunks, iters=iters, mode="chunked",
                interpret=True)
            S, P = t(S_ext.copy()), t(proc.copy())
            got = port_kernel.peel_loop(S, P, u, v, Es, N, Eid,
                                        None if pin is None else t(pin),
                                        m=m, work_cap=cap, stop_live=stop)
            assert np.array_equal(S.numpy(), np.asarray(want_S))
            assert np.array_equal(P.numpy(), np.asarray(want_P))
            assert (got.levels, got.sublevels) == (int(want_lv),
                                                   int(want_sb))
            assert got.host_reads == got.sublevels and got.wait_ns >= 0
            segments += got.levels > 0
    assert segments >= 2


def test_plain_peel_loop_stops_past_its_cap():
    """A state the peel never reaches (slot ``m`` left live: no level's
    frontier can take it) stops after ``m`` sub-levels with
    ``KernelError``, as the kernel does, instead of looping forever."""
    from repro_torch.kernels.cuda_build import KernelError

    g = port_build(_er(12, 0.5, 3))
    m = g.m
    t = torch.tensor
    S = t(np.append(np.zeros(m, np.int32), SENT))
    P = torch.zeros(m + 1, dtype=torch.bool)
    with pytest.raises(KernelError, match=f"after {m + 1} sub-levels"):
        port_kernel.peel_loop(S, P, t(g.El[:, 0]), t(g.El[:, 1]), t(g.Es),
                              t(g.N), t(g.Eid), m=m,
                              work_cap=port_kernel.work_capacity(m, 2 * m))


def _star(k):
    return np.stack([np.zeros(k, np.int64), np.arange(1, k + 1)], axis=1)


@pytest.mark.parametrize("mode", port_pkt.PEEL_MODES)
def test_empty_graph(mode):
    g = port_build(np.zeros((0, 2), np.int64))
    res = port_pkt.pkt(g, mode=mode, device="cpu")
    assert res.trussness.shape == (0,) and res.support.shape == (0,)
    assert (res.levels, res.sublevels, res.compactions) == (0, 0, 0)
    tabs, chunk, n_chunks = port_pkt.prepare_peel(
        port_pkt.support_mod.build_peel_table(g), g.m, 1 << 14, device="cpu")
    assert (chunk, n_chunks) == (1, 1)
    assert tabs.e1.tolist() == [0] and tabs.hi.tolist() == [0]


@pytest.mark.parametrize("mode", port_pkt.PEEL_MODES)
def test_triangle_free_graphs(mode):
    for edges in (_star(5), np.array([[0, 1], [1, 2], [2, 3], [3, 4]],
                                     np.int64)):
        ref = ref_pkt.pkt(ref_build(edges))
        res = port_pkt.pkt(port_build(edges), mode=mode, device="cpu")
        assert (res.trussness == 2).all() and (res.support == 0).all()
        assert (res.levels, res.sublevels) == (ref.levels, ref.sublevels)


@pytest.mark.parametrize("edges", [
    np.array([[0, 1]], np.int64),                     # m == 1
    np.array([[0, 1], [1, 2]], np.int64),             # m == 2, no triangle
    np.array([[0, 1], [0, 2], [1, 2]], np.int64),     # smallest triangle
])
@pytest.mark.parametrize("chunk", [1, 3, 1 << 20])
def test_tiny_graph_huge_chunk(edges, chunk):
    """chunk >> table size must clamp, not produce n_chunks == 0."""
    want = truss_numpy(port_build(edges).El)
    for mode in port_pkt.PEEL_MODES:
        for table_mode in ("numpy", "device"):
            got = port_pkt.pkt(port_build(edges), mode=mode, chunk=chunk,
                               table_mode=table_mode, device="cpu")
            assert np.array_equal(got.trussness, want), (mode, chunk)
