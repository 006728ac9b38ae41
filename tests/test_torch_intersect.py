"""Port parity: K3 (``intersect_blocked``) and the degree-class support path.

The port of ``tests/test_kernels.py``: the same seeded numpy rows go through
the JAX package's Pallas kernel (interpret mode) and the port's wrapper on
the CPU (its plain version), and every output must be equal — the outputs
are integer masks and counts, so equality is exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st, HealthCheck

import jax.numpy as jnp

from repro.core.ref import support_naive
from repro.core.support import compute_support as ref_compute_support
from repro.graphs.csr import build_csr as ref_build
from repro.graphs.csr import edges_from_arrays
from repro.graphs.gen import rmat_edges
from repro.kernels.intersect import intersect_blocked as ref_intersect
from repro.kernels.ops import compute_support_kernel as ref_support_kernel
from repro.kernels.ref import intersect_ref as ref_intersect_ref

from repro_torch.graphs.csr import build_csr as port_build
from repro_torch.kernels import intersect as port_kernel
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels.intersect import intersect_blocked, intersect_ref


def _rows(rng, E, D, pad, universe=500, dtype=np.int32):
    out = np.full((E, D), pad, dtype)
    for i in range(E):
        k = int(rng.integers(0, D + 1))
        vals = np.unique(rng.choice(universe, size=k, replace=False)) \
            if k else np.zeros(0, dtype)
        out[i, :len(vals)] = np.sort(vals)
    return out


def _port(a, b, **kw):
    got = intersect_blocked(torch.from_numpy(a), torch.from_numpy(b), **kw)
    for t in got:
        assert t.dtype == torch.int32
    return [t.numpy() for t in got]


def _assert_equal(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("E,DA,DB", [
    (1, 8, 8), (5, 8, 32), (17, 16, 16), (64, 32, 8), (33, 64, 128),
    (128, 128, 128), (3, 256, 64), (2, 256, 256),
])
@pytest.mark.parametrize("block_rows", [4, 64])
def test_kernel_shape_sweep(E, DA, DB, block_rows):
    rng = np.random.default_rng(E * 1000 + DA + DB)
    a = _rows(rng, E, DA, -1)
    b = _rows(rng, E, DB, -2)
    want = ref_intersect(jnp.asarray(a), jnp.asarray(b),
                         block_rows=block_rows, interpret=True)
    _assert_equal(_port(a, b, block_rows=block_rows), want)


def test_kernel_int16_ids():
    """dtype sweep: the kernel contract is dtype-generic over int types."""
    rng = np.random.default_rng(7)
    a = _rows(rng, 9, 16, -1, universe=120, dtype=np.int16)
    b = _rows(rng, 9, 16, -2, universe=120, dtype=np.int16)
    want = ref_intersect(jnp.asarray(a), jnp.asarray(b), interpret=True)
    _assert_equal(_port(a, b), want)


@given(st.integers(0, 2**31 - 1), st.integers(1, 40),
       st.sampled_from([8, 16, 32]), st.sampled_from([8, 16, 32]))
@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
def test_property_kernel_vs_ref(seed, E, DA, DB):
    rng = np.random.default_rng(seed)
    a = _rows(rng, E, DA, -1, universe=60)
    b = _rows(rng, E, DB, -2, universe=60)
    want = ref_intersect(jnp.asarray(a), jnp.asarray(b), block_rows=8,
                         interpret=True)
    _assert_equal(_port(a, b, block_rows=8), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_unsorted_and_duplicate_rows(dtype):
    """The contract assumes no order: shuffled rows with repeated ids (and
    pads in the middle) give the reference oracle's masks and counts."""
    rng = np.random.default_rng(3 if dtype == np.int32 else 4)
    E, DA, DB = 37, 24, 40
    a = rng.integers(0, 20, size=(E, DA)).astype(dtype)
    b = rng.integers(0, 20, size=(E, DB)).astype(dtype)
    a[rng.random((E, DA)) < 0.2] = -1
    b[rng.random((E, DB)) < 0.2] = -2
    want = ref_intersect_ref(jnp.asarray(a), jnp.asarray(b))
    _assert_equal(_port(a, b, block_rows=5), want)
    # the plain version, called directly, is the same function
    _assert_equal([t.numpy() for t in intersect_ref(torch.from_numpy(a),
                                                    torch.from_numpy(b))],
                  want)


def _run_rows(rng, E, D, pad, kind, dtype):
    """(E, D) rows of one layout: "duplicates" (sorted with repeated ids,
    then ``pad``), "full" (one sorted run, no padding), "padding" (all
    ``pad``) or "runs<k>" (``k`` sorted runs, no padding; fewer when D <
    2k)."""
    out = np.full((E, D), pad, dtype)
    if kind == "padding":
        return out
    for i in range(E):
        if kind == "duplicates":
            vals = np.sort(rng.integers(0, 2 * D,
                                        size=int(rng.integers(0, D + 1))))
        elif kind == "full":
            vals = np.sort(rng.integers(0, 2 * D, size=D))
        else:
            k = min(int(kind[4:]), D // 2)
            lens = [D // k] * (k - 1) + [D - (D // k) * (k - 1)]
            # each run climbs from 0 to 2D, so each boundary descends
            vals = np.concatenate([np.sort(np.concatenate(
                [[0, 2 * D], rng.integers(0, 2 * D, size=n - 2)]))
                for n in lens])
        out[i, :vals.size] = vals
    return out


def _n_runs(row) -> int:
    """Maximal non-decreasing runs of one row (0 for an empty row)."""
    return int(row.size > 0) + int((np.diff(row.astype(np.int64)) < 0).sum())


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("kind", ["duplicates", "full", "padding", "runs2",
                                  "runs3", "runs4", "runs5"])
@pytest.mark.parametrize("E,DA,DB", [(9, 16, 16), (6, 40, 64)])
def test_sorted_run_layouts(E, DA, DB, kind, dtype):
    """The row layouts between which the kernel chooses its path — CSR-like
    rows with duplicates, one run with no padding, all padding, 2 to 5
    sorted runs — give the Pallas kernel's outputs."""
    rng = np.random.default_rng(E * DB + len(kind))
    a = _run_rows(rng, E, DA, -1, "duplicates", dtype)
    b = _run_rows(rng, E, DB, -2, kind, dtype)
    if kind.startswith("runs"):
        assert {_n_runs(row) for row in b} == {int(kind[4:])}
    elif kind != "padding":
        assert all(_n_runs(row) <= 2 for row in b)
    if kind == "padding":
        a[:, 0] = -2  # an id equal to the padding matches all of it
    want = ref_intersect(jnp.asarray(a), jnp.asarray(b), block_rows=4,
                         interpret=True)
    _assert_equal(_port(a, b, block_rows=4), want)


def test_plain_version_walks_slices(monkeypatch):
    """Slicing the plain version's rows changes no result."""
    rng = np.random.default_rng(5)
    a = _rows(rng, 50, 16, -1, universe=40)
    b = _rows(rng, 50, 32, -2, universe=40)
    want = _port(a, b)
    monkeypatch.setattr(port_kernel, "_REF_PAIRS", 16 * 32 * 3)
    _assert_equal(_port(a, b), want)


def test_wrapper_counts_and_rejects():
    """CPU tensors run the plain version (counted as plain, never as a
    launch); malformed operands raise before anything runs."""
    a = torch.tensor([[1, 2, -1]], dtype=torch.int32)
    b = torch.tensor([[2, 3, -2, -2]], dtype=torch.int32)
    before = port_kernel.COUNTS.as_dict()
    cnt, hita, hitb = intersect_blocked(a, b)
    assert port_kernel.COUNTS.plain == before["plain"] + 1
    assert port_kernel.COUNTS.kernel == before["kernel"]
    assert cnt.tolist() == [1]
    assert hita.tolist() == [[0, 1, 0]] and hitb.tolist() == [[1, 0, 0, 0]]
    with pytest.raises(ValueError, match="must be"):
        intersect_blocked(a, b[:, :, None])
    with pytest.raises(TypeError, match="id type"):
        intersect_blocked(a, b.to(torch.int16))
    with pytest.raises(ValueError, match="block_rows"):
        intersect_blocked(a, b, block_rows=0)
    with pytest.raises(ValueError, match="device"):
        intersect_blocked(a.to("meta"), b.to("meta"))


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    return edges_from_arrays(src, dst, n)


def _graphs(E):
    gr, gp = ref_build(E), port_build(E)
    for f in ("N", "Eid", "Es", "Eo", "El"):
        assert np.array_equal(getattr(gr, f), getattr(gp, f)), f
    return gr, gp


@pytest.mark.parametrize("classes", [None, (8,), (8, 16)])
def test_support_kernel_end_to_end(classes):
    """compute_support_kernel equals the reference's, with the default
    classes and with tiny classes that force the fallback path."""
    E = _er(70, 0.25, 11)
    gr, gp = _graphs(E)
    kw = {} if classes is None else dict(classes=classes)
    want = ref_support_kernel(gr, interpret=True, **kw)
    got = port_ops.compute_support_kernel(gp, device="cpu", **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_compute_support(gr))


def test_support_kernel_skewed_graph_uses_every_path():
    """An R-MAT graph fills several degree classes and the fallback; the
    result equals the reference, and K3's plain version ran once per
    non-empty bucket."""
    E = rmat_edges(8, edge_factor=8, seed=1)
    gr, gp = _graphs(E)
    buckets, fallback = port_ops.degree_buckets(gp, (8, 16))
    assert len(buckets) == 2 and fallback.size > 0
    before = port_kernel.COUNTS.plain
    got = port_ops.compute_support_kernel(gp, classes=(8, 16), device="cpu")
    assert port_kernel.COUNTS.plain - before == len(buckets)
    want = ref_support_kernel(gr, classes=(8, 16), interpret=True)
    np.testing.assert_array_equal(got, want)


def test_bucket_rows_match_reference_gather():
    """The padded K3 operands of one bucket equal the reference's gather."""
    from repro.kernels.ops import _gather_rows as ref_gather

    gr, gp = _graphs(_er(40, 0.3, 2))
    buckets, _ = port_ops.degree_buckets(gp)
    dev = gp.device_arrays("cpu")
    for D, ids, us, ul, vs, vl in buckets:
        got = port_ops.bucket_rows(dev["N"], dev["Eid"], torch.tensor(us),
                                   torch.tensor(ul), torch.tensor(vs),
                                   torch.tensor(vl), D)
        ra, ea, _ = ref_gather(jnp.asarray(gr.N), jnp.asarray(gr.Eid),
                               jnp.asarray(us), jnp.asarray(ul), D)
        rb, eb, _ = ref_gather(jnp.asarray(gr.N), jnp.asarray(gr.Eid),
                               jnp.asarray(vs), jnp.asarray(vl), D)
        rb = jnp.where(rb < 0, -2, rb)
        for t, w in zip(got, (ra, ea, rb, eb)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_fallback_table_matches_host_rows():
    """The device-built fallback rows equal the reference's np.repeat rows,
    in order."""
    E = rmat_edges(7, edge_factor=6, seed=4)
    gr, gp = _graphs(E)
    _, fb = port_ops.degree_buckets(gp, (8,))
    assert fb.size
    u = gr.El[fb, 0].astype(np.int64)
    v = gr.El[fb, 1].astype(np.int64)
    Es, Eo = gr.Es.astype(np.int64), gr.Eo.astype(np.int64)
    cnt = Es[v + 1] - Eo[v]
    off = np.concatenate([[0], np.cumsum(cnt)])
    local = np.repeat(np.arange(fb.size), cnt)
    intra = np.arange(int(off[-1])) - off[local]
    want = (fb[local], Eo[v[local]] + intra, Eo[u[local]], Es[u[local] + 1])
    got = port_ops.fallback_table(gp, fb, torch.device("cpu"))
    for t, w in zip(got, want):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), w)


@pytest.mark.parametrize("seed", range(4))
def test_support_equals_naive(seed):
    E = _er(12 + 9 * seed, 0.25, 10 + seed)
    if E.size == 0:
        return
    gr, gp = _graphs(E)
    S_naive = support_naive(gr.El, np.ones(gr.m, bool))
    got = port_ops.compute_support_kernel(gp, device="cpu")
    np.testing.assert_array_equal(got, S_naive)
    np.testing.assert_array_equal(got, ref_support_kernel(gr, interpret=True))
