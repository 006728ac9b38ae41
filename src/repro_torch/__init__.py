"""PyTorch + CUDA port of the truss decomposition system (``src/repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
module by module (``graphs/csr.py``, ``core/pkt.py``, ``kernels/support.py``
…) and runs on one NVIDIA H100: plain tensor code in PyTorch, and the two
wedge-scan Pallas kernels as hand-written CUDA kernels for ``sm_90a``
(``kernels/csrc/``).  It imports neither ``jax`` nor anything of ``repro``.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises rather than running on the CPU.  ``device="cpu"`` runs every
executor as plain PyTorch — what the CPU tests compare bitwise against the
JAX package.
"""

from repro_torch import core, graphs, kernels, serve
from repro_torch.core import compute_support, pkt, truss_pkt
from repro_torch.device import resolve_device
from repro_torch.serve import TrussEngine, truss_batched

__all__ = ["core", "graphs", "kernels", "serve", "compute_support", "pkt",
           "truss_pkt", "resolve_device", "TrussEngine", "truss_batched"]
