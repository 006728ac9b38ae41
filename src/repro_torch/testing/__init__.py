"""Test support: deterministic fault injection at the dispatch sites."""

from repro_torch.testing.chaos import (DISPATCH_SITES, FaultPlan,
                                       InjectedFault, activate, deactivate,
                                       fault_point)

__all__ = ["DISPATCH_SITES", "FaultPlan", "InjectedFault", "activate",
           "deactivate", "fault_point"]
