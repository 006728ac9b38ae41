"""Graph500 Kronecker graphs: a frozen generator of the benchmark's own.

GraphChallenge's static graph challenge (Samsi et al., "Static Graph
Challenge: Subgraph Isomorphism", IEEE HPEC 2017) has a k-truss task whose
graphs include ``graph500-scale<s>-ef16``, made by the Graph500 Kronecker
generator: 2^scale vertex ids, ``edge_factor * 2^scale`` rows, each row's
endpoints drawn bit by bit with the initiator A / B / C / D = 0.57 / 0.19 /
0.19 / 0.05, vertex labels permuted, self-loops and duplicate edges
dropped.  The files are not in the repository, so this module draws the
graph from a seed the same way.

At each of the ``scale`` bit levels a row goes to the lower half of the
source ids with probability A + B, and then to the lower half of the
destination ids with probability A / (A + B) (upper source half: C / (C +
D)).  The labels are a seeded permutation of the ids.  The edges come out
once each, ordered by their canonical key; the seed also flips each row's
endpoint order with a fair coin, as an edge file lists them either way.

Nothing here reads or imports the program under test.
"""

from __future__ import annotations

import numpy as np


def kronecker_rows(scale: int, edge_factor: int, a: float, b: float,
                   c: float, rng: np.random.Generator) -> np.ndarray:
    """``edge_factor * 2^scale`` raw (src, dst) rows, labels permuted:
    (k, 2) int64 with self-loops and repeats still in."""
    n = 1 << scale
    k = edge_factor * n
    src = np.zeros(k, np.int64)
    dst = np.zeros(k, np.int64)
    p_src_low = a + b
    p_dst_low = np.array([a / (a + b), c / (1.0 - a - b)])
    for _ in range(scale):
        src_high = rng.random(k) >= p_src_low
        dst_high = rng.random(k) >= p_dst_low[src_high.astype(np.int64)]
        src = 2 * src + src_high
        dst = 2 * dst + dst_high
    label = rng.permutation(n)
    return np.stack([label[src], label[dst]], axis=1)


def canonical(rows: np.ndarray, n: int) -> np.ndarray:
    """The distinct edges of ``rows`` without self-loops, each as (u, v)
    with u < v, in ascending order of ``u * n + v``."""
    lo = np.minimum(rows[:, 0], rows[:, 1])
    hi = np.maximum(rows[:, 0], rows[:, 1])
    keys = np.unique((lo * n + hi)[lo != hi])
    return np.stack([keys // n, keys % n], axis=1)


def make(params: dict, seed: int) -> dict:
    """The seed's graph.

    Returns ``{"graphs": [E], "rows": R}``: ``E`` the (m, 2) int64
    canonical edges (u < v), ``R`` the same edges in the same order with
    each row's endpoints flipped by the seed's coin.
    """
    if abs(params["a"] + params["b"] + params["c"] + params["d"] - 1) > 1e-9:
        raise ValueError("the initiator's four shares must add up to 1")
    rng = np.random.default_rng(seed)
    n = 1 << int(params["scale"])
    E = canonical(kronecker_rows(int(params["scale"]),
                                 int(params["edge_factor"]), params["a"],
                                 params["b"], params["c"], rng), n)
    flip = rng.random(E.shape[0]) < 0.5
    R = np.where(flip[:, None], E[:, ::-1], E)
    return {"graphs": [E], "rows": R}
