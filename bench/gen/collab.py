"""COLLAB-like ego networks: a frozen generator calibrated to the source.

COLLAB (Yanardag & Vishwanathan, KDD 2015; TUDataset) holds 5,000 ego
networks of physicists from three collaboration networks (high-energy,
condensed-matter and astro physics; 2,600 / 775 / 1,625 graphs), with
74.49 vertices and 2,457.78 edges per graph on average, 32 to 492
vertices.  Its files are not in the repository, so this module builds a
collection of the same shape from a seed: each graph is an ego (vertex 0)
and its co-authors, made as the union of the cliques of their papers, the
ego on every paper.

What is fixed and what the seed draws:

* The set of graph sizes (vertices, target edges, class) is the same for
  every seed: vertices are the quantiles of a log-normal cut to
  [32, 492], whose location is solved so that their mean is the source's;
  target edges are a density from a second quantile grid times the vertex
  pairs, with the density's exponent solved so that their mean is the
  source's.  The seed shuffles the order of the collection and draws the
  papers.
* Papers: first a cover of the co-authors (so every co-author shares a
  paper with the ego), then random papers of the class's author counts
  while they fit under the target, then three-author papers (the ego and
  two co-authors not yet linked) up to the target exactly.  A graph whose
  cover alone passes its target keeps the cover.

Nothing here reads or imports the program under test.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

#: class shares of the source (high-energy, condensed-matter, astro),
#: as a pattern of 200 graphs: 104 / 31 / 65
CLASS_PATTERN = (104, 31, 65)
CLASSES = ("hep", "cm", "astro")

#: most papers past the cover, and the share of the missing links that
#: they fill in expectation (three-author papers fill the rest)
BLOCK = 4096
FILL_SHARE = 0.9


def _truncated_lognormal_quantiles(n: int, mu: float, sigma: float,
                                   lo: float, hi: float) -> np.ndarray:
    nd = NormalDist()
    a = nd.cdf((np.log(lo) - mu) / sigma)
    b = nd.cdf((np.log(hi) - mu) / sigma)
    q = a + (b - a) * (np.arange(n) + 0.5) / n
    z = np.array([nd.inv_cdf(float(x)) for x in q])
    return np.exp(mu + sigma * z)


def _bisect(fn, lo: float, hi: float, target: float, iters: int = 60):
    """The argument where the increasing ``fn`` reaches ``target``."""
    for _ in range(iters):
        mid = (lo + hi) / 2
        if fn(mid) < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def sizes(p: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The collection's (vertices, target edges, class) per graph, in a
    fixed order that no seed changes."""
    count = int(p["graphs"])
    lo, hi = p["min_vertices"], p["max_vertices"]
    sigma = p["vertex_log_sigma"]

    def verts(mu):
        return np.round(_truncated_lognormal_quantiles(count, mu, sigma,
                                                       lo, hi))

    mu = _bisect(lambda x: verts(x).mean(), 0.0, 8.0, p["mean_vertices"])
    nv = verts(mu).astype(np.int64)
    pairs = nv * (nv - 1) / 2
    # a second grid of quantiles, paired with the sizes by a fixed stride
    u = (np.arange(count) + 0.5) / count
    u = u[(np.arange(count) * p["density_stride"]) % count]
    dlo, dhi = p["min_density"], p["max_density"]

    def edges(gamma):
        dens = dlo + (dhi - dlo) * u ** gamma
        return np.clip(np.round(dens * pairs), nv - 1, p["max_edges"])

    # edges fall as the exponent rises: solve on the negated mean
    gamma = _bisect(lambda g: -edges(g).mean(), 0.01, 20.0,
                    -p["mean_edges"])
    me = edges(gamma).astype(np.int64)
    pattern = np.repeat(np.arange(len(CLASS_PATTERN)), CLASS_PATTERN)
    cls = pattern[np.arange(count) % pattern.size]
    return nv, me, cls


def _paper_sizes(rng, cls: int, p: dict, k: int) -> np.ndarray:
    """Co-authors on ``k`` papers besides the ego (each at least 1)."""
    name = CLASSES[cls]
    if name == "hep":
        return 1 + rng.lognormal(np.log(p["hep_median_coauthors"]),
                                 p["hep_log_sigma"], k).astype(np.int64)
    return 1 + rng.poisson(p[f"{name}_mean_coauthors"], k)


def _coauthor_links(member: np.ndarray) -> np.ndarray:
    """Pairs of co-authors that share one of these papers (c, c) bool,
    diagonal included."""
    w = member.astype(np.float32)
    return (w.T @ w) > 0


def ego_graph(rng, n: int, m_target: int, cls: int, p: dict) -> np.ndarray:
    """One ego network as canonical (m, 2) int64 rows, u < v, key-sorted.

    The cover partitions the co-authors into papers.  Further papers are as
    many as fill ``FILL_SHARE`` of the missing links in expectation; each
    co-author joins a paper of ``s`` co-authors with probability ``s / c``.
    Three-author papers then fill up to the target exactly.
    """
    c = n - 1                                   # co-authors, ids 1..n-1
    sz = _paper_sizes(rng, cls, p, c)           # enough for any cover
    groups = np.searchsorted(np.cumsum(sz), np.arange(c), side="right")
    gid = np.empty(c, np.int64)
    gid[rng.permutation(c)] = groups
    links = gid[:, None] == gid[None, :]        # diagonal set throughout
    need = m_target - c                         # links the papers may add

    def count(lk):
        return (int(lk.sum()) - c) // 2

    have = count(links)
    if have < need:
        # as many papers as fill FILL_SHARE of the missing links, in
        # expectation: a free pair joins a paper of share r with chance r^2
        share = np.minimum(_paper_sizes(rng, cls, p, BLOCK), c) / c
        free = c * (c - 1) // 2 - have
        expect = free * (1 - np.cumprod(1 - share ** 2))
        k = int(np.searchsorted(expect, FILL_SHARE * (need - have),
                                side="right"))
        member = rng.random((k, c)) < share[:k, None]
        while k:
            grown = links | _coauthor_links(member[:k])
            if count(grown) <= need:
                links = grown
                break
            k = k * 3 // 4                      # rare: drop the last papers
    iu = np.triu_indices(c, 1)
    pairs = links[iu]
    short = need - int(pairs.sum())
    if short > 0:                               # three-author papers
        free = np.flatnonzero(~pairs)
        pairs[rng.choice(free, size=short, replace=False)] = True
    A = np.zeros((n, n), bool)
    A[0, 1:] = True
    A[iu[0][pairs] + 1, iu[1][pairs] + 1] = True
    u, v = np.nonzero(A)
    return np.stack([u, v], axis=1).astype(np.int64)


def make(params: dict, seed: int) -> dict:
    """The collection in the seed's order: ``{"graphs": [...], "sizes":
    (vertices, target edges, class) in that order}``."""
    nv, me, cls = sizes(params)
    rng = np.random.default_rng(seed)
    order = rng.permutation(nv.size)
    graphs = [ego_graph(rng, int(nv[i]), int(me[i]), int(cls[i]), params)
              for i in order]
    return {"graphs": graphs, "vertices": nv[order], "classes": cls[order]}
