"""Serving layer: the batched truss engine (one-shot tickets and persistent
handles that absorb edge churn and answer community queries) and the async
scheduler over it, with its retry, deadline and degradation machinery."""

from repro_torch.serve.resilience import (DeadlineExceeded, Ladder,
                                          RetryPolicy, Wedged)
from repro_torch.serve.scheduler import (Cancelled, Overloaded,
                                         TrussScheduler)
from repro_torch.serve.truss_engine import (TrussEngine, TrussHandle,
                                            truss_batched)

__all__ = ["Cancelled", "DeadlineExceeded", "Ladder", "Overloaded",
           "RetryPolicy", "TrussEngine", "TrussHandle", "TrussScheduler",
           "Wedged", "truss_batched"]
