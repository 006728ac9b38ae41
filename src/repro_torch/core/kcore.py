"""k-core decomposition: BZ (host oracle) and ParK-style level-synchronous.

The paper preprocesses every graph with a k-core decomposition and a
coreness reordering (its Table 2 shows up to 17x triangle-counting speedups
from the ordering); ``core.prep.degeneracy_order`` calls ``kcore_numpy``
for it.  PKT itself is "based on a recently proposed algorithm for k-core
decomposition" (ParK):

  - ``kcore_numpy``: Batagelj–Zaversnik bucket peeling, O(n + m). Oracle.
  - ``kcore_park``:  ParK-style level-synchronous peeling — the same
    curr/next frontier pattern PKT uses, over vertices.  ``coreness`` runs
    it over a CSR on the tensors' device: on a CUDA device as one
    cooperative launch (``kernels/kcore.py: core_loop``), elsewhere as
    ``peel_cores``, torch ops with the loops on the host (one read per
    sub-level), which is also the kernel's oracle.  ``core/prep.py`` runs
    it on rows that never left the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels import kcore as kcore_kernel


def kcore_numpy(g: CSRGraph) -> np.ndarray:
    """BZ algorithm: returns coreness per vertex (int32), O(n + m).

    The same bucket moves as the JAX package's ``kcore_numpy``, run over
    Python lists instead of numpy scalars (the loop is inherently serial,
    and list indexing is several times cheaper than numpy element access).
    """
    n = g.n
    if n == 0:
        return np.zeros(0, np.int32)
    deg = g.degrees.astype(np.int64)
    md = int(deg.max(initial=0))
    # bucket sort vertices by degree
    counts = np.zeros(md + 2, dtype=np.int64)
    np.add.at(counts, deg + 1, 1)
    bin_start = np.cumsum(counts).tolist()
    fill = bin_start[:-1]
    pos = [0] * n
    vert = [0] * n
    core = deg.tolist()
    for v in range(n):
        d = core[v]
        pos[v] = fill[d]
        vert[fill[d]] = v
        fill[d] += 1
    Es = g.Es.tolist()
    N = g.N.tolist()
    for i in range(n):
        v = vert[i]
        cv = core[v]
        for j in range(Es[v], Es[v + 1]):
            u = N[j]
            du = core[u]
            if du > cv:
                # move u one bucket down (swap with first vertex of its bucket)
                pu = pos[u]
                pw = bin_start[du]
                w = vert[pw]
                if u != w:
                    vert[pu], vert[pw] = w, u
                    pos[u], pos[w] = pw, pu
                bin_start[du] += 1
                core[u] = du - 1
    return np.asarray(core, dtype=np.int32)


def kcore_park(g: CSRGraph, *, device="cuda") -> np.ndarray:
    """ParK-style k-core; returns coreness per vertex (int32).

    ``coreness`` over the graph's CSR on ``device``: "cuda" (the default;
    raises when no card is present) or "cpu".
    """
    device = resolve_device(device)
    if g.n == 0:
        return np.zeros(0, np.int32)
    arrays = g.device_arrays(device)
    return coreness(arrays["Es"], arrays["N"]).core.cpu().numpy()


def coreness(Es: torch.Tensor, N: torch.Tensor) -> kcore_kernel.CoreResult:
    """Every vertex's coreness from the int32 CSR ``(Es, N)`` on its
    device (row ``v`` is ``N[Es[v]:Es[v+1]]``, each undirected edge a slot
    each way): ``kernels.kcore.core_loop`` on a CUDA device, one launch and
    one host read; ``peel_cores`` elsewhere, one read a sub-level.  Both
    run the same sub-levels and give the coreness as int32."""
    if Es.device.type == "cuda":
        return kcore_kernel.core_loop(Es, N)
    kcore_kernel.COUNTS.ran_plain()
    deg = Es[1:] - Es[:-1]
    row_of_slot = torch.repeat_interleave(
        torch.arange(deg.shape[0], dtype=torch.int32, device=Es.device),
        deg.to(torch.int64), output_size=N.shape[0])
    core, subs = peel_cores(N, row_of_slot, deg)
    return kcore_kernel.CoreResult(core, subs, subs, 0)


def peel_cores(nbr: torch.Tensor, row_of_slot: torch.Tensor,
               deg: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The level-synchronous peel of ``kcore_park`` over device arrays.

    ``nbr[j]`` and ``row_of_slot[j]`` are the two ends of adjacency slot
    ``j`` (every undirected edge has a slot each way; their order is free)
    and ``deg`` the vertices' degrees, whose dtype the coreness takes.
    Level ``l`` removes, sub-level by sub-level, the frontier ``{v alive :
    deg[v] <= l}`` at once and subtracts from every vertex the number of
    its neighbours that just died: an ``index_add_`` of the dead slots
    (each slot adds its 0 or 1 at its own neighbour, so no address collects
    the zeros).  The loops run on the host and read ``[#frontier, #alive]``
    once per sub-level; a level ends with an empty sub-level, as in the JAX
    package.  Returns the coreness (on ``deg``'s device) and the number of
    sub-levels run.
    """
    n = deg.shape[0]
    device = deg.device
    core = torch.zeros(n, dtype=deg.dtype, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    l, todo, subs = 0, n, 0
    while todo > 0:
        moved = 1
        while moved > 0:
            frontier = alive & (deg <= l)
            core = torch.where(frontier, l, core)
            alive &= ~frontier
            dec = torch.zeros(n, dtype=deg.dtype, device=device)
            dec.index_add_(0, nbr, frontier[row_of_slot].to(deg.dtype))
            deg = torch.where(alive, deg - dec, deg)
            moved, todo = torch.stack([frontier.sum(), alive.sum()]).tolist()
            subs += 1
        l += 1
    return core, subs
