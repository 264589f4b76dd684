"""Float arithmetic that must round exactly as the JAX package does."""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["div"]


@functools.lru_cache(maxsize=1024)
def _divisor(s: float, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """The 0-d divisor tensor, made once per value, dtype and device:
    making a tensor on the card copies from the host and waits on the
    stream, which a loop of block descents must not do per call."""
    return torch.tensor(s, dtype=dtype, device=device)


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as one correctly rounded division in ``x``'s dtype.

    JAX weak-types a Python float divisor to the array's dtype and
    divides.  PyTorch on CUDA turns division by a host scalar into a
    multiplication by its reciprocal, which rounds differently (and can
    move a particle across a cell boundary or flip a nearest-neighbour
    tie), so the divisor goes in as a 0-d tensor on ``x``'s device.
    """
    return x / _divisor(float(s), x.dtype, x.device)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX weak-types a Python float: a
    tensor times this Python float multiplies by exactly that value."""
    return float(np.float32(x))
