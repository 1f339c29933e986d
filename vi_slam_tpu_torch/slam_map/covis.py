"""Incremental covisibility graph and spanning tree, on the host — a numpy
copy of the JAX package's native covisibility graph
(`native/src/covis_graph.cpp`, loaded by `vi_slam_tpu/native.py`).

Each keyframe keeps a map neighbour -> number of shared map points. A new
keyframe's parent in the spanning tree is its strongest earlier
neighbour; on equal weights the native graph keeps the first one its
`std::unordered_map<int32_t, int32_t>` iterates over, so this copy keeps
each neighbour map in libstdc++'s iteration order (`_HashOrder`) and
picks the same parent. The essential-graph edge list is gathered in that
order as well, so that a truncation at `max_edges` drops the same edges.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

import numpy as np

# libstdc++'s _Prime_rehash_policy::_M_next_bkt: small requests use this
# table; larger ones the least listed prime >= n
_FAST_BKT = (2, 2, 2, 3, 5, 5, 7, 7, 11, 11, 11, 11, 13, 13)
_PRIMES = (
    17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89, 97, 103, 109,
    113, 127, 137, 139, 149, 157, 167, 179, 193, 199, 211, 227, 241, 257, 277, 293, 313,
    337, 359, 383, 409, 439, 467, 503, 541, 577, 619, 661, 709, 761, 823, 887, 953, 1031,
    1109, 1193, 1289, 1381, 1493, 1613, 1741, 1879, 2029, 2179, 2357, 2549, 2753, 2971,
    3209, 3469, 3739, 4027, 4349,
)


def _next_bkt(n: int) -> int:
    if n < len(_FAST_BKT):
        return _FAST_BKT[n]
    i = bisect.bisect_left(_PRIMES, n)
    if i == len(_PRIMES):
        raise ValueError(f"a neighbour map of {n} buckets is beyond the copied prime table")
    return _PRIMES[i]


class _HashOrder:
    """An int -> int map that iterates in the order libstdc++'s
    unordered_map with the identity hash does: a node goes to the front of
    its bucket's run of the node list, or to the front of the whole list
    when its bucket is empty; a rehash re-inserts the nodes in list order
    by the same rule; erasing keeps the order of the rest."""

    def __init__(self):
        self.vals: Dict[int, int] = {}
        self.order: List[int] = []
        self.n_bkt = 1
        self.next_resize = 0

    @staticmethod
    def _insert_pos(order: List[int], key: int, n_bkt: int) -> int:
        b = key % n_bkt
        for i, k in enumerate(order):
            if k % n_bkt == b:
                return i
        return 0

    def _rehash(self, n_bkt: int) -> None:
        new: List[int] = []
        for k in self.order:
            new.insert(self._insert_pos(new, k, n_bkt), k)
        self.order = new
        self.n_bkt = n_bkt

    def incr(self, key: int) -> None:
        if key in self.vals:
            self.vals[key] += 1
            return
        n_elt = len(self.vals)
        if n_elt + 1 > self.next_resize:
            min_bkts = max(n_elt + 1, 0 if self.next_resize else 11)
            if min_bkts >= self.n_bkt:
                n = _next_bkt(max(min_bkts + 1, self.n_bkt * 2))
                self.next_resize = n
                self._rehash(n)
            else:
                self.next_resize = self.n_bkt
        self.order.insert(self._insert_pos(self.order, key, self.n_bkt), key)
        self.vals[key] = 1

    def erase(self, key: int) -> None:
        if key in self.vals:
            del self.vals[key]
            self.order.remove(key)

    def clear(self) -> None:
        self.vals.clear()
        self.order.clear()

    def items(self):
        return [(k, self.vals[k]) for k in self.order]

    def get(self, key: int, default: int = 0) -> int:
        return self.vals.get(key, default)


class CovisGraph:
    """Covisibility weights between keyframes and the spanning tree."""

    def __init__(self, max_kf: int):
        self.max_kf = max_kf
        self._weights = [_HashOrder() for _ in range(max_kf)]
        self._point_obs: Dict[int, List[int]] = {}
        self._parent = np.full((max_kf,), -1, np.int32)
        self._alive = np.zeros((max_kf,), bool)

    def add_keyframe(self, kf: int, mp_ids: np.ndarray) -> None:
        """Register keyframe `kf` with the map points it observes (-1 =
        none): count shared points against every earlier live observer,
        then take the strongest earlier neighbour as parent (else the most
        recent live keyframe)."""
        if kf < 0 or kf >= self.max_kf:
            return
        self._alive[kf] = True
        wk = self._weights[kf]
        for mp in np.asarray(mp_ids, np.int64).tolist():
            if mp < 0:
                continue
            obs = self._point_obs.setdefault(mp, [])
            for other in obs:
                if other == kf or not self._alive[other]:
                    continue
                wk.incr(other)
                self._weights[other].incr(kf)
            if kf not in obs:
                obs.append(kf)
        best, best_w = -1, 0
        for other, w in wk.items():
            if other < kf and self._alive[other] and w > best_w:
                best, best_w = other, w
        if best < 0 and kf > 0:
            earlier = np.flatnonzero(self._alive[:kf])
            best = int(earlier[-1]) if earlier.size else -1
        self._parent[kf] = best

    def remove_keyframe(self, kf: int) -> None:
        """Cull a keyframe: drop its edges and observations; its children
        take its parent."""
        if kf < 0 or kf >= self.max_kf or not self._alive[kf]:
            return
        for other, _ in self._weights[kf].items():
            self._weights[other].erase(kf)
        self._weights[kf].clear()
        for obs in self._point_obs.values():
            while kf in obs:
                obs.remove(kf)
        self._parent[self._parent == kf] = self._parent[kf]
        self._alive[kf] = False
        self._parent[kf] = -1

    def weight(self, a: int, b: int) -> int:
        if a < 0 or a >= self.max_kf:
            return 0
        return self._weights[a].get(b, 0)

    def best_neighbors(self, kf: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The n strongest neighbours, by weight then lower id."""
        if kf < 0 or kf >= self.max_kf:
            return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
        v = sorted(self._weights[kf].items(), key=lambda kv: (-kv[1], kv[0]))[:n]
        return (np.asarray([k for k, _ in v], np.int32).reshape(-1),
                np.asarray([w for _, w in v], np.int32).reshape(-1))

    def parents(self) -> np.ndarray:
        return self._parent.copy()

    def essential_edges(self, min_weight: int, max_edges: int = 4096) -> np.ndarray:
        """(E, 2) sorted unique pairs (i < j): spanning-tree edges and
        covisibility edges of weight >= min_weight, at most max_edges
        gathered before the deduplication."""
        out: List[Tuple[int, int]] = []

        def push(a, b):
            if len(out) < max_edges:
                out.append((min(a, b), max(a, b)))

        for k in range(self.max_kf):
            if not self._alive[k]:
                continue
            p = int(self._parent[k])
            if p >= 0 and self._alive[p]:
                push(p, k)
            for other, w in self._weights[k].items():
                if other > k and self._alive[other] and w >= min_weight:
                    push(k, other)
        return np.asarray(sorted(set(out)), np.int32).reshape(-1, 2)
