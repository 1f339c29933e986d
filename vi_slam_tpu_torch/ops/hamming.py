"""Hamming distances between packed 256-bit descriptors — a PyTorch copy
of the JAX package's `ops/hamming.py`.

Descriptors are (.., 8) int32 words holding uint32 bit patterns. The
distance matrix is r1 + r2 - 2 <b1, b2> over unpacked {0, 1} bits; the
float32 product is exact (integers below 2^24, TF32 off).
"""

from __future__ import annotations

import torch

from vi_slam_tpu_torch.ops.orb import unpack_bits


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of the 32-bit pattern held in each int32 (or int64) word,
    returned as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_bits(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(N, M) int32 distances from unpacked (N, 256) / (M, 256) bits."""
    r1 = torch.sum(b1, dim=-1)
    r2 = torch.sum(b2, dim=-1)
    inner = b1 @ b2.T
    return torch.round(r1[:, None] + r2[None, :] - 2.0 * inner).to(torch.int32)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, M) int32 distance matrix of packed descriptors."""
    return hamming_matrix_bits(unpack_bits(d1), unpack_bits(d2))
