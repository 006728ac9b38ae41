"""Where the port's tensors live: the card by default, the CPU on request.

Every entry point of the port (``truss_pkt``, ``pkt``, ``compute_support``,
``TrussEngine``) takes ``device=`` and resolves it here.  The default is
``"cuda"``; when no card is present the call raises instead of quietly
running on the CPU, so a run that was meant for the GPU can never
report CPU numbers.  ``device="cpu"`` is the explicit opt-in the tests use:
on CPU tensors every ``"kernel"`` executor runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """Validate a ``device=`` argument; raise when CUDA is asked for but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch executors on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
