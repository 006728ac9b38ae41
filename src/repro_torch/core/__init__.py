"""Core: PKT truss decomposition, its support phase, and the host oracles."""

from repro_torch.core.pkt import pkt, truss_pkt, PKTResult, peel_live_subset
from repro_torch.core.support import (
    compute_support,
    triangle_count,
    build_support_table,
    build_peel_table,
    support_table_size,
    peel_table_size,
    SUPPORT_MODES,
    TABLE_MODES,
)
from repro_torch.core.ref import truss_numpy
from repro_torch.core.kcore import kcore_numpy

__all__ = [
    "pkt", "truss_pkt", "PKTResult", "peel_live_subset",
    "compute_support", "triangle_count",
    "build_support_table", "build_peel_table",
    "support_table_size", "peel_table_size", "SUPPORT_MODES", "TABLE_MODES",
    "truss_numpy", "kcore_numpy",
]
