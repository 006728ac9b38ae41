"""Serving layer: the batched truss engine (one-shot tickets and persistent
handles that absorb edge churn and answer community queries)."""

from repro_torch.serve.truss_engine import (TrussEngine, TrussHandle,
                                            truss_batched)

__all__ = ["TrussEngine", "TrussHandle", "truss_batched"]
