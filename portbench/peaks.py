"""The card's published peaks and the least time a call could take.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet, at its full
700 W power limit (the run prints the card's own limit beside every
share): 3.35 TB/s of device memory, 67 TFLOP/s of float32 outside the
tensor cores.  Copied from ``chip_smoke.py:_bound``.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "bound_s", "nbytes"]

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least seconds on the card: the larger of bytes over the memory
    rate and operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)
