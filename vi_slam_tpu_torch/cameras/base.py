"""Camera parameters — a PyTorch copy of the JAX package's
`cameras/base.py` (the pinhole model; the fisheye model comes later)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraParams(NamedTuple):
    """Intrinsics as 0-dim float32 tensors on the working device.

    dist: radial-tangential coefficients [k1, k2, p1, p2, k3].
    bf: stereo baseline * fx (pixels * metres), 0 for mono rigs.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (5,)
    bf: torch.Tensor

    @classmethod
    def make(cls, fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0, 0.0), bf=0.0,
             dtype=torch.float32, device="cpu") -> "CameraParams":
        d = torch.zeros((5,), dtype=dtype, device=device)
        dist = tuple(dist)
        if dist:
            d[: len(dist)] = torch.tensor(dist, dtype=dtype, device=device)

        def s(v):
            return torch.tensor(v, dtype=dtype, device=device)

        return cls(fx=s(fx), fy=s(fy), cx=s(cx), cy=s(cy), dist=d, bf=s(bf))
