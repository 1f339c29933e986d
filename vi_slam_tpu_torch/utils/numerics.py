"""Float32 functions computed bit for bit as the JAX package computes them
on the CPU, where the main path takes a discontinuous decision on their
last bit.

The predicted pyramid level of a map point is ceil(log(ratio) / log(1.2)).
Seen from the pose that created it, a point's ratio is a power of the scale
factor, so the quotient lies within an ulp of an integer and the last bit
of `log` decides the level. XLA's CPU log is a Cephes polynomial (Eigen's
`plog`), not torch's: the two differ in the last bit for about 13 % of
inputs. `log_f32` evaluates XLA's polynomial with the fused multiply-adds
its compiler forms, each emulated in float64 (the product of two float32
values is exact there), so the port predicts the same levels on the CPU
and on the card.
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding, through float64."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive, finite float32 values, as XLA's CPU log."""
    x = torch.clamp(x, min=1.1754943508222875e-38)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = m < 0.7071067690849304
    e = e - small.to(torch.float32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    a = fma_f32(x, 0.07037683576345444, -0.11514610052108765)
    b = fma_f32(x, -0.12420140951871872, 0.14249323308467865)
    c = fma_f32(x, 0.2000071406364441, -0.24999994039535522)
    a = fma_f32(a, x, 0.11676998436450958)
    b = fma_f32(b, x, -0.16668057441711426)
    c = fma_f32(c, x, 0.3333333134651184)
    y = fma_f32(a, x3, b)
    y = fma_f32(y, x3, c)
    y = fma_f32(y, x3, e * -0.00021219444170128554)
    r = fma_f32(x2, -0.5, x) + y
    return fma_f32(e, 0.693359375, r)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (taken in float64: torch's
    float32 sqrt on the CPU is not always correctly rounded)."""
    return torch.sqrt(x.double()).float()


def norm3_f32(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis (of size 3), as XLA's CPU
    `jnp.linalg.norm` rounds it: sqrt(fma(z, z, fma(y, y, x * x))), the
    square root correctly rounded (taken in float64: torch's float32 sqrt
    on the CPU is not always)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    n = sqrt_f32(fma_f32(z, z, fma_f32(y, y, x * x)))
    return n[..., None] if keepdim else n


def lu3_pivots(A: torch.Tensor) -> torch.Tensor:
    """(..., 3) pivots of the LU factorization with partial pivoting of
    float32 3x3 matrices (..., 3, 3), rounded as the JAX package's CPU LU
    (LAPACK's getrf) rounds them: multipliers by the reciprocal pivot, the
    second column's update by separately rounded products, the last pivot
    as a22 - fma(l21, u12, l20 * u02). A zero pivot here is a zero pivot
    there, where `jnp.linalg.inv` returns non-finite rows."""
    a = A
    p0 = torch.argmax(torch.abs(a[..., :, 0]), dim=-1)  # first maximum, as isamax
    a = _swap_rows(a, 0, p0)
    piv0 = a[..., 0, 0]
    # getrf leaves the column unscaled below a zero pivot
    r0 = torch.where(piv0 != 0, 1.0 / piv0, torch.ones_like(piv0))
    l10, l20 = a[..., 1, 0] * r0, a[..., 2, 0] * r0
    u01, u02 = a[..., 0, 1], a[..., 0, 2]
    b11 = a[..., 1, 1] - l10 * u01
    b21 = a[..., 2, 1] - l20 * u01
    swap = torch.abs(b21) > torch.abs(b11)
    l10, l20 = torch.where(swap, l20, l10), torch.where(swap, l10, l20)
    u11, b21 = torch.where(swap, b21, b11), torch.where(swap, b11, b21)
    a12 = torch.where(swap, a[..., 2, 2], a[..., 1, 2])
    a22 = torch.where(swap, a[..., 1, 2], a[..., 2, 2])
    l21 = b21 * torch.where(u11 != 0, 1.0 / u11, torch.ones_like(u11))
    u12 = a12 - l10 * u02
    u22 = a22 - fma_f32(l21, u12, l20 * u02)
    return torch.stack([piv0, u11, u22], dim=-1)


def _swap_rows(a: torch.Tensor, i: int, p: torch.Tensor) -> torch.Tensor:
    """Swap row i with row p[...] of each 3x3 matrix."""
    idx = torch.arange(3, device=a.device).expand(*p.shape, 3).clone()
    idx[..., i] = p
    idx.scatter_(-1, p[..., None], torch.full_like(p[..., None], i))
    return torch.gather(a, -2, idx[..., None].expand(*idx.shape, 3))
