"""k-core decomposition: the Batagelj–Zaversnik bucket peel (host oracle).

The paper preprocesses every graph with a k-core decomposition and a
coreness reordering (its Table 2 shows up to 17x triangle-counting speedups
from the ordering); ``graphs.csr.degeneracy_order`` calls ``kcore_numpy``
for it.  The level-synchronous device variant (``kcore_park`` in the JAX
package) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph


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
