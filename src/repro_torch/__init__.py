"""PyTorch + CUDA port of the truss decomposition system (``src/repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
module by module (``graphs/csr.py``, ``core/pkt.py``, ``kernels/support.py``
…) and runs on one NVIDIA H100: plain tensor code in PyTorch, and the three
Pallas kernels as hand-written CUDA kernels for ``sm_90a``
(``kernels/csrc/``).  It imports neither ``jax`` nor anything of ``repro``.

Two user paths: the one-shot decomposition (``truss_pkt``, the engine's
``submit``/``flush``), and persistent handles (``TrussEngine.open`` /
``update`` / ``close``, ``core/truss_inc.py``) that absorb edge churn by
local repair and answer k-truss community queries (``core/hierarchy.py``).
``serve/scheduler.py`` serves both asynchronously (``TrussScheduler``, with
the retry and degradation ladders of ``serve/resilience.py``);
``testing/chaos.py`` holds the seeded fault plans the dispatch sites
consult.  ``core/pkt_dist.py`` runs PKT over ``torch.distributed`` ranks.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises rather than running on the CPU.  ``device="cpu"`` runs every
executor as plain PyTorch — what the CPU tests compare bitwise against the
JAX package.
"""

from repro_torch import core, graphs, kernels, serve, testing
from repro_torch.core import (IncrementalTruss, TrussHierarchy,
                              compute_support, pkt, truss_pkt)
from repro_torch.device import resolve_device
from repro_torch.serve import TrussEngine, TrussHandle, truss_batched

__all__ = ["core", "graphs", "kernels", "serve", "testing",
           "compute_support", "pkt", "truss_pkt", "resolve_device",
           "IncrementalTruss", "TrussHierarchy", "TrussEngine",
           "TrussHandle", "truss_batched"]
