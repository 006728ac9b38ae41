"""Port parity: distributed PKT (``repro_torch.core.pkt_dist``).

The three truss tests of ``tests/test_distributed.py``, run as 2- and
4-rank ``gloo`` process groups on the CPU: one subprocess per rank, joined
by a ``file://`` rendezvous under the test's own directory (no TCP port
for parallel test workers to fight over), each with a time limit so a hang
fails instead of stalling the suite.  Every rank's trussness must equal the
JAX package's ``truss_pkt`` bitwise, for both support executors.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.pkt import truss_pkt as ref_truss_pkt

from repro_torch.core.pkt_dist import edge_ranges
from repro_torch.core.support import support_table_size
from repro_torch.graphs.csr import build_csr
from repro_torch.kernels.support import support_accumulate_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: one rank: joins the group, decomposes the graph in ``data`` with each
#: executor pairing named there, and checks every result bitwise
_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, data = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
from repro_torch.core.pkt_dist import _rank_of, pkt_dist
from repro_torch.graphs.csr import build_csr

d = np.load(data)
g = build_csr(d["El"], int(d["n"]))
assert g.m == d["El"].shape[0]
assert _rank_of(None, torch.device("cpu"))[1:] == (world, rank)
try:
    _rank_of(None, torch.device("cuda"))       # gloo cannot serve CUDA
    raise AssertionError("a gloo group was accepted for CUDA tensors")
except ValueError as e:
    assert "nccl" in str(e)
for mode in d["modes"]:
    sm, tm = str(mode).split("/")
    t = pkt_dist(g, chunk=int(d["chunk"]), support_mode=sm, table_mode=tm,
                 device="cpu")
    assert t.dtype == np.int64 and t.shape == (g.m,)
    assert np.array_equal(t, d["want"]), (rank, mode)
dist.barrier()
dist.destroy_process_group()
print("OK", rank, g.m)
"""


def _er_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    src, dst = np.nonzero(np.triu(mask, 1))
    return build_csr(np.stack([src, dst], axis=1).astype(np.int64), n)


def _run_ranks(tmp_path, world: int, g, want, *, chunk: int, modes):
    """Start ``world`` ranks on ``g``; every one must print OK."""
    data = tmp_path / "graph.npz"
    np.savez(data, El=g.El, n=g.n, want=want, chunk=chunk,
             modes=np.array(modes))
    init = (tmp_path / "rendezvous").as_uri()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), init, str(data)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (code, out, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
        assert out.strip() == f"OK {r} {g.m}", out


@pytest.mark.parametrize("world", [2, 4])
def test_pkt_dist_matches_single_device(tmp_path, world):
    g = _er_graph(50, 0.25, 5)
    want = ref_truss_pkt(g.El, reorder=False)
    _run_ranks(tmp_path, world, g, want, chunk=64,
               modes=["kernel/device", "torch/device"])


@pytest.mark.parametrize("world", [2, 4])
def test_pkt_dist_support_kernel_sharded(tmp_path, world):
    """``support_mode="kernel"``: each rank runs K1 over its own edge range
    (the plain version on the CPU); equal to the torch executor over the
    table slices, with tables from the device builders and from the host."""
    g = _er_graph(40, 0.25, 11)
    want = ref_truss_pkt(g.El, reorder=False)
    _run_ranks(tmp_path, world, g, want, chunk=64,
               modes=["torch/device", "kernel/device", "torch/numpy",
                      "kernel/numpy"])


@pytest.mark.parametrize("world", [2, 4])
def test_support_dist_equals_local(tmp_path, world):
    """The distributed trussness equals the JAX package's, row for row; and
    K1's edge ranges (the plain version) sum to the whole-range call."""
    g = _er_graph(64, 0.2, 9)
    want = ref_truss_pkt(g.El, reorder=False)
    _run_ranks(tmp_path, world, g, want, chunk=32, modes=["kernel/device"])

    arr = g.device_arrays("cpu")
    args = tuple(arr[k] for k in ("u", "v", "Es", "Eo", "N", "Eid"))
    rows = support_table_size(g)
    kw = dict(m=g.m, chunk=8, n_chunks=-(-rows // 8))
    S_all, tri_all = support_accumulate_ref(*args, **kw)
    bounds = edge_ranges(g, world)
    assert bounds[0] == 0 and bounds[-1] == g.m
    assert (np.diff(bounds) >= 0).all()
    parts = [support_accumulate_ref(*args, **kw, e_begin=int(a),
                                    e_end=int(b))
             for a, b in zip(bounds[:-1], bounds[1:])]
    assert torch.equal(sum(p[0] for p in parts), S_all)
    assert torch.equal(sum(p[1] for p in parts), tri_all)
    assert int(S_all[:g.m].sum()) == 3 * int(tri_all.sum()) > 0
