"""Float arithmetic that must round exactly as the JAX package does."""
from __future__ import annotations

import torch

__all__ = ["div"]


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as one correctly rounded division in ``x``'s dtype.

    JAX weak-types a Python float divisor to the array's dtype and
    divides.  PyTorch on CUDA turns division by a host scalar into a
    multiplication by its reciprocal, which rounds differently (and can
    move a particle across a cell boundary or flip a nearest-neighbour
    tie), so the divisor goes in as a 0-d tensor on ``x``'s device.
    """
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)
