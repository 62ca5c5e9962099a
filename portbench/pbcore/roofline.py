"""The card's peaks and the operations and bytes of the kernels that the
per-layer metrics hold against them.  Kept here, not taken from the
program, so that a later change to the program cannot move the yardstick.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 67 TFLOP/s
in float32 outside the tensor cores (the port runs with TF32 off) and
3.35 TB/s of HBM."""
from __future__ import annotations

from typing import Iterable, Sequence

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def knn_ops(n1: int, n2: int, dim: int) -> float:
    """Multiply and add of every pair of valid descriptors: 2 n1 n2 dim."""
    return 2.0 * n1 * n2 * dim


def knn_bytes(n1: int, n2: int, dim: int, k: int) -> float:
    """Valid float32 descriptors read once, and the k-NN lists written
    (a float32 distance and an int64 index each)."""
    return 4.0 * (n1 + n2) * dim + 12.0 * n1 * k


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: max(ops / peak, bytes / peak)."""
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def conv_macs(layers: Iterable[Sequence[int]], P: int) -> int:
    """Multiply-adds of a patch [P, P] through convolutions given as
    (in channels, out channels, kernel, stride, padding); frozen copy of
    chip_smoke.conv_macs, taking the layer list from the configuration's
    file instead of the net's weights."""
    macs, side = 0, P
    for ci, co, k, stride, pad in layers:
        side = (side + 2 * pad - k) // stride + 1
        macs += co * ci * k * k * side * side
    return macs
