"""Core: PKT truss decomposition (single-device and distributed over
``torch.distributed`` ranks), its support phase, the paper's baselines, the
host oracles, incremental maintenance and the truss community index."""

from repro_torch.core.pkt import pkt, truss_pkt, PKTResult, peel_live_subset
from repro_torch.core.pkt_dist import pkt_dist
from repro_torch.core.support import (
    compute_support,
    compute_support_ros,
    triangle_count,
    build_support_table,
    build_peel_table,
    support_table_size,
    peel_table_size,
    SUPPORT_MODES,
    TABLE_MODES,
)
from repro_torch.core.wc import truss_wc
from repro_torch.core.ros import truss_ros
from repro_torch.core.ref import truss_numpy
from repro_torch.core.triangle_list import truss_trilist, enumerate_triangles
from repro_torch.core.kcore import kcore_numpy, kcore_park
from repro_torch.core.truss_inc import (
    IncrementalTruss,
    IntegrityError,
    UpdateStats,
    INSERT_MODES,
    compose_update_batches,
    triangle_list,
)
from repro_torch.core.hierarchy import (
    TrussHierarchy,
    HIER_MODES,
    hierarchy_from_graph,
)

__all__ = [
    "pkt", "truss_pkt", "PKTResult", "peel_live_subset", "pkt_dist",
    "compute_support", "compute_support_ros", "triangle_count",
    "build_support_table", "build_peel_table",
    "support_table_size", "peel_table_size", "SUPPORT_MODES", "TABLE_MODES",
    "truss_wc", "truss_ros", "truss_numpy",
    "truss_trilist", "enumerate_triangles",
    "kcore_numpy", "kcore_park",
    "IncrementalTruss", "IntegrityError", "UpdateStats", "INSERT_MODES",
    "compose_update_batches", "triangle_list",
    "TrussHierarchy", "HIER_MODES", "hierarchy_from_graph",
]
