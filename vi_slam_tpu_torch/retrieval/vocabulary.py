"""Bag-of-binary-words vocabulary — a PyTorch copy of the JAX package's
`retrieval/vocabulary.py` (the DBoW3 equivalent).

The tree is a flat centroid matrix with static per-level offsets: level l
holds k^(l+1) nodes. `transform` descends it with one batched Hamming
computation per level (each descriptor against its node's k children).
Training is constrained k-means, one level at a time over all nodes of
the level at once: a descriptor may only move among its parent's
children, and a node's centroid is the bit majority of its descriptors.

Scores are DBoW3's L1 score on L1-normalized TF-IDF vectors,
s = sum_i min(v_i, w_i).

Descriptors are (N, 8) int32 words holding uint32 bit patterns. The saved
file format is the reference's (`np.savez_compressed` with packed bits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.ops.orb import unpack_bits
from vi_slam_tpu_torch.utils.device import resolve_device


class Vocabulary(NamedTuple):
    """node_bits: (n_nodes, 256) float32 {0, 1} centroids of every node,
    levels concatenated; idf: (n_words,) float32; k: branching factor;
    levels: depth (n_words = k^levels)."""

    node_bits: torch.Tensor
    idf: torch.Tensor
    k: int
    levels: int

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    @property
    def offsets(self) -> Tuple[int, ...]:
        return _offsets(self.k, self.levels)

    def to(self, device) -> "Vocabulary":
        return self._replace(node_bits=self.node_bits.to(device), idf=self.idf.to(device))


def _offsets(k: int, levels: int) -> Tuple[int, ...]:
    off, total = [], 0
    for l in range(levels):
        off.append(total)
        total += k ** (l + 1)
    return tuple(off)


def _n_nodes(k: int, levels: int) -> int:
    return sum(k ** (l + 1) for l in range(levels))


def _child_distances(bits: torch.Tensor, node_bits: torch.Tensor, child_base: torch.Tensor,
                     k: int) -> torch.Tensor:
    """(N, k) float32 Hamming distances from each descriptor's bits
    (N, 256) to its k candidate children (global index child_base + j).
    The counts are integers below 2^24, so float32 holds them exactly."""
    idx = child_base[:, None].long() + torch.arange(k, device=bits.device)[None, :]
    cand = node_bits[idx]  # (N, k, 256)
    inner = torch.einsum("nd,nkd->nk", bits, cand)
    return torch.sum(bits, dim=-1)[:, None] + torch.sum(cand, dim=-1) - 2.0 * inner


def transform_bits(bits: torch.Tensor, node_bits: torch.Tensor, k: int, levels: int,
                   node_level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descend the tree: (leaf word (N,), ancestor at `node_level` (N,))
    int32. Ties go to the lower child, as `jnp.argmin` gives."""
    offsets = _offsets(k, levels)
    n = bits.shape[0]
    local = torch.zeros((n,), dtype=torch.int32, device=bits.device)
    node_id = torch.zeros_like(local)
    for l in range(levels):
        d = _child_distances(bits, node_bits, offsets[l] + local * k, k)
        local = local * k + torch.argmin(d, dim=-1).to(torch.int32)
        if l == node_level:
            node_id = local
    return local, node_id


def transform(vocab: Vocabulary, desc: torch.Tensor, node_level: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed descriptors (N, 8) -> (words (N,), nodes (N,)); node_level
    defaults to levels - 3 (clipped at 0)."""
    if node_level is None:
        node_level = max(vocab.levels - 3, 0)
    return transform_bits(unpack_bits(desc), vocab.node_bits, vocab.k, vocab.levels, node_level)


def bow_vectors(words: torch.Tensor, valid: torch.Tensor, idf: torch.Tensor,
                n_words: int) -> torch.Tensor:
    """Words (..., N) and validity -> L1-normalized TF-IDF vectors (..., W)."""
    lead = words.shape[:-1]
    w = torch.where(valid, words, torch.zeros_like(words)).reshape(-1, words.shape[-1]).long()
    ones = valid.reshape(w.shape).to(torch.float32)
    tf = torch.zeros((w.shape[0], n_words), dtype=torch.float32, device=words.device)
    tf.scatter_add_(1, w, ones)
    v = tf.reshape(*lead, n_words) * idf
    norm = torch.sum(torch.abs(v), dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=1e-12)


def score_l1(query: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """DBoW3 L1 score of a query (W,) against refs (K, W); 1 = identical."""
    return torch.sum(torch.minimum(query[None, :], refs), dim=-1)


def _level_kmeans_iter(bits, node_bits, parent, k: int, offset: int, n_level: int):
    """One constrained k-means iteration over every node of one level:
    (new node_bits, assignment (N,) local ids within the level). A node
    that receives no descriptor keeps its centroid."""
    d = _child_distances(bits, node_bits, offset + parent * k, k)
    assign = parent * k + torch.argmin(d, dim=-1).to(torch.int32)
    a = assign.long()
    ones = torch.zeros((n_level, bits.shape[1]), dtype=bits.dtype, device=bits.device)
    ones.index_add_(0, a, bits)
    cnt = torch.zeros((n_level,), dtype=bits.dtype, device=bits.device)
    cnt.index_add_(0, a, torch.ones_like(bits[:, 0]))
    maj = (ones * 2.0 > cnt[:, None]).to(bits.dtype)
    prev = node_bits[offset:offset + n_level]
    node_bits = node_bits.clone()
    node_bits[offset:offset + n_level] = torch.where((cnt > 0)[:, None], maj, prev)
    return node_bits, assign


def train_vocabulary(desc, k: int = 10, levels: int = 4, iters: int = 8,
                     image_ids: Optional[np.ndarray] = None, seed: int = 0,
                     device=None) -> Vocabulary:
    """Train a hierarchical binary vocabulary on (N, 8) packed descriptors
    (numpy uint32 or int32, or an int32 tensor). The k-means runs on
    `device`; without one, on the tensor's own device, and for numpy
    descriptors on the card (which raises where there is none). The random initialisation
    draws from numpy's generator exactly as the reference does, and the
    k-means sums are of {0, 1} values, so the same seed gives the
    reference's centroids. image_ids (N,) gives the IDF weights; without
    it every word weighs 1."""
    if device is None:
        device = desc.device if isinstance(desc, torch.Tensor) else "cuda"
    device = resolve_device(device)
    if not isinstance(desc, torch.Tensor):
        desc = torch.from_numpy(np.ascontiguousarray(np.asarray(desc).astype(np.uint32).view(np.int32)))
    rng = np.random.default_rng(seed)
    bits_d = unpack_bits(desc.to(device))
    bits = bits_d.cpu().numpy()
    n = bits.shape[0]
    node_bits = np.zeros((_n_nodes(k, levels), 256), np.float32)
    offsets = _offsets(k, levels)
    parent = np.zeros((n,), np.int32)
    for l in range(levels):
        n_level = k ** (l + 1)
        # child j of parent p <- a random descriptor of p's partition;
        # random bits for the nodes whose parent has none
        order = rng.permutation(n)
        init = node_bits[offsets[l]:offsets[l] + n_level]
        init[:] = (rng.random((n_level, 256)) < 0.5).astype(np.float32)
        fill = np.zeros(n_level, bool)
        for idx in order:
            p = parent[idx]
            free = np.flatnonzero(~fill[p * k:(p + 1) * k])
            if free.size:
                init[p * k + free[0]] = bits[idx]
                fill[p * k + free[0]] = True
        nb = torch.from_numpy(node_bits).to(device)
        par_d = torch.from_numpy(parent).to(device)
        assign = par_d
        for _ in range(iters):
            nb, assign = _level_kmeans_iter(bits_d, nb, par_d, k, offsets[l], n_level)
        node_bits = nb.cpu().numpy().copy()
        parent = assign.cpu().numpy()

    words = parent
    n_words = k ** levels
    if image_ids is not None:
        n_imgs = int(image_ids.max()) + 1
        seen = np.zeros((n_words,), np.float64)
        for im in range(n_imgs):
            seen[np.unique(words[image_ids == im])] += 1.0
        idf = np.maximum(np.log(n_imgs / np.maximum(seen, 1.0)).astype(np.float32), 1e-3)
    else:
        idf = np.ones((n_words,), np.float32)
    return Vocabulary(node_bits=torch.from_numpy(node_bits).to(device),
                      idf=torch.from_numpy(idf).to(device), k=k, levels=levels)


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    np.savez_compressed(
        path,
        node_bits=np.packbits(vocab.node_bits.cpu().numpy().astype(np.uint8), axis=-1),
        idf=vocab.idf.cpu().numpy(),
        k=vocab.k,
        levels=vocab.levels,
    )


def load_vocabulary(path: str, device="cuda") -> Vocabulary:
    """Load a vocabulary saved by `save_vocabulary` (or the reference's
    writer) onto `device`; the default card raises where there is none."""
    device = resolve_device(device)
    z = np.load(path)
    bits = np.unpackbits(z["node_bits"], axis=-1).astype(np.float32)
    return Vocabulary(
        node_bits=torch.from_numpy(bits).to(device),
        idf=torch.from_numpy(np.asarray(z["idf"], np.float32)).to(device),
        k=int(z["k"]),
        levels=int(z["levels"]),
    )
