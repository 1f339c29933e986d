"""RANSAC sample draws on an explicit `torch.Generator`.

The JAX package draws its RANSAC samples inside its jitted solvers with
`jax.random.choice(key, N, shape, p=valid / n_valid)`. The port keeps the
draw apart from the solvers (which take the index array), so a caller can
replace it: `Sampler` is the default, and a test may hand a solver the
reference's own draws instead. `KeySampler` reproduces the reference's
stream itself (its threefry2x32 key, split before every draw), without
JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
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


_M32 = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def blocked_cumsum(x: np.ndarray, block: int = 16) -> np.ndarray:
    """float32 inclusive prefix sums in XLA's order on the CPU: in-order
    sums within blocks of `block`, each offset by the prefix of the
    earlier blocks' totals (taken the same way), the two-level scan XLA
    rewrites a long cumulative sum into. Bit-equal to `jnp.cumsum` there,
    where a plain running sum is not."""
    n = x.shape[0]
    m = -(-n // block)
    q = np.zeros(m * block, np.float32)
    q[:n] = x
    inner = np.cumsum(q.reshape(m, block), axis=1, dtype=np.float32)
    if m == 1:
        return inner[0, :n]
    before = np.concatenate([np.zeros(1, np.float32), blocked_cumsum(inner[:, -1], block)[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


def threefry2x32(key: np.ndarray, count: np.ndarray):
    """The threefry2x32 block cipher (20 rounds) of (2,) uint32 `key` over
    64-bit counters `count` (uint64, split into high and low words): the
    pair of uint32 words JAX's threefry PRNG computes for them."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x0 = (count >> np.uint64(32)).astype(np.uint32) + ks[0]
    x1 = (count & _M32).astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


class KeySampler:
    """The JAX package's draw, reproduced on the host without JAX: a key
    seeded as `jax.random.PRNGKey(seed)` ((0, seed) as uint32), split
    before every draw (`key, sub = jax.random.split(key)`), and the indices
    of `jax.random.choice(sub, N, (n_hyp, size), p=valid / n_valid)`: its
    float32 uniforms from the same counter bits (JAX's partitionable
    threefry), searched in the cumulative weights summed in XLA's order.
    For the same valid mask the indices are the reference's (one host read
    of the mask a draw)."""

    def __init__(self, seed: int):
        self.key = np.array([0, seed & 0xFFFFFFFF], np.uint32)

    def split(self) -> np.ndarray:
        a, b = threefry2x32(self.key, np.arange(2, dtype=np.uint64))
        self.key = np.array([a[0], b[0]], np.uint32)
        return np.array([a[1], b[1]], np.uint32)

    def uniform(self, sub: np.ndarray, n: int) -> np.ndarray:
        a, b = threefry2x32(sub, np.arange(n, dtype=np.uint64))
        bits = (a ^ b) >> np.uint32(9) | np.uint32(0x3F800000)
        return bits.view(np.float32) - np.float32(1.0)

    def __call__(self, valid: torch.Tensor, n_hyp: int, sample_size: int) -> torch.Tensor:
        w = valid.cpu().numpy().astype(np.float32)
        cum = blocked_cumsum(w / max(w.sum(), np.float32(1.0)))
        u = self.uniform(self.split(), n_hyp * sample_size)
        idx = np.searchsorted(cum, cum[-1] * (np.float32(1.0) - u), side="left")
        idx = np.minimum(idx, valid.shape[0] - 1).reshape(n_hyp, sample_size)
        return torch.from_numpy(idx.astype(np.int64)).to(valid.device)
