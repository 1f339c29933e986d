"""RANSAC sample draws on an explicit `torch.Generator`.

The JAX package draws its RANSAC samples inside its jitted solvers with
`jax.random.choice(key, N, shape, p=valid / n_valid)`. The port keeps the
draw apart from the solvers (which take the index array), so a caller can
replace it: `Sampler` is the default, and a test may hand a solver the
reference's own draws instead.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# (valid (N,) bool, n_hyp, sample_size) -> (n_hyp, sample_size) int64
DrawFn = Callable[[torch.Tensor, int, int], torch.Tensor]


def sample_indices(valid: torch.Tensor, n_hyp: int, sample_size: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """(n_hyp, sample_size) int64 indices drawn with replacement, each
    valid entry equally likely: inverse-CDF sampling on the cumulative
    weights, as `jax.random.choice` with `p` samples (not its stream)."""
    w = valid.to(torch.float32)
    cum = torch.cumsum(w / torch.clamp(torch.sum(w), min=1.0), dim=0)
    u = torch.rand((n_hyp * sample_size,), generator=generator, device=valid.device)
    idx = torch.searchsorted(cum, cum[-1] * (1.0 - u), side="left")
    return torch.clamp(idx, max=valid.shape[0] - 1).reshape(n_hyp, sample_size)


class Sampler:
    """The default draw: `sample_indices` on a generator seeded `seed` on
    `device`, advanced by every draw."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def __call__(self, valid: torch.Tensor, n_hyp: int, sample_size: int) -> torch.Tensor:
        return sample_indices(valid, n_hyp, sample_size, self.generator)
