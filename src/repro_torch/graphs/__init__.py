"""Graph substrate: generators, CSR construction, datasets (host numpy).

All graphs are undirected simple graphs held in the paper's (Fig. 2) layout:
CSR ``(Es, N)`` plus ``Eid`` (edge id per adjacency slot), ``El`` (edge list,
u < v), ``Eo`` (first adjacency slot whose neighbor is > the row vertex).
"""

from repro_torch.graphs.csr import CSRGraph, build_csr, relabel, edges_from_arrays
from repro_torch.graphs.gen import (
    rmat_edges,
    erdos_renyi_edges,
    barabasi_albert_edges,
    ring_of_cliques_edges,
)
from repro_torch.graphs.datasets import named_graph, GRAPH_SUITE

__all__ = [
    "CSRGraph",
    "build_csr",
    "relabel",
    "edges_from_arrays",
    "rmat_edges",
    "erdos_renyi_edges",
    "barabasi_albert_edges",
    "ring_of_cliques_edges",
    "named_graph",
    "GRAPH_SUITE",
]
