"""Serving layer: the batched truss engine (one-shot tickets)."""

from repro_torch.serve.truss_engine import TrussEngine, truss_batched

__all__ = ["TrussEngine", "truss_batched"]
