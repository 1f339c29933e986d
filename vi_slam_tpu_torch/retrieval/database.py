"""Keyframe place-recognition database — a PyTorch copy of the JAX
package's `retrieval/database.py`.

The inverted file is a dense (K, W) matrix of BoW vectors. A query is two
stages over a fixed candidate cap: stage 1 keeps the keyframes that share
more than 0.8x the best common-word count and pass the score gate, and
takes the best `n_cand` by L1 score; stage 2 accumulates each candidate's
score over its 10 strongest covisible keyframes (from the map's
incidence arrays) and keeps, for each group above 0.75x the best
accumulated score, its best-scoring keyframe.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.ops.fast import top_k
from vi_slam_tpu_torch.retrieval.vocabulary import score_l1
from vi_slam_tpu_torch.slam_map.state import MapState
from vi_slam_tpu_torch.utils.device import resolve_device


class DBState(NamedTuple):
    bow: torch.Tensor  # (K, W) float32 L1-normalized TF-IDF per keyframe
    valid: torch.Tensor  # (K,) bool


def allocate(max_keyframes: int, n_words: int, device="cuda") -> DBState:
    device = resolve_device(device)
    return DBState(
        bow=torch.zeros((max_keyframes, n_words), dtype=torch.float32, device=device),
        valid=torch.zeros((max_keyframes,), dtype=torch.bool, device=device),
    )


def add(db: DBState, slot: int, bow_vec: torch.Tensor) -> DBState:
    db.bow[slot] = bow_vec.to(db.bow.dtype)
    db.valid[slot] = True
    return db


def remove(db: DBState, slot: int) -> DBState:
    db.bow[slot] = 0.0
    db.valid[slot] = False
    return db


def _common_words(db: DBState, query_bow: torch.Tensor) -> torch.Tensor:
    return torch.sum(((query_bow > 0)[None, :] & (db.bow > 0)).to(torch.float32), dim=-1)


def _stage1(db: DBState, query_bow: torch.Tensor, exclude: torch.Tensor,
            min_score: torch.Tensor, n_cand: int):
    """Word sharing and score filter: (cand_ids (n_cand,) int32, -1 pads;
    cand_scores; common-word counts)."""
    ok = db.valid & ~exclude
    common = torch.where(ok, _common_words(db, query_bow), torch.zeros((), device=db.bow.device))
    scores = score_l1(query_bow, db.bow)
    pass_mask = ok & (common > 0.8 * torch.max(common)) & (scores >= min_score)
    ranked = torch.where(pass_mask, scores, torch.full_like(scores, -1.0))
    top_scores, top_ids = top_k(ranked, n_cand)
    top_ids = torch.where(top_scores > 0, top_ids, torch.full_like(top_ids, -1))
    return top_ids.to(torch.int32), top_scores, common


def _stage2(db: DBState, state: MapState, query_bow: torch.Tensor, cand_ids: torch.Tensor,
            cand_scores: torch.Tensor, group_size: int = 10):
    """Covisibility-group accumulation: (best keyframe of each kept group
    (n_cand,) int32, -1 elsewhere; accumulated scores, -1 for pads)."""
    K = db.valid.shape[0]
    C = cand_ids.shape[0]
    scores_all = score_l1(query_bow, db.bow)
    word_share = _common_words(db, query_bow)
    safe = torch.clamp(cand_ids, min=0).long()
    mp = state.kf_mp[safe]  # (C, N)
    has = mp >= 0
    obs_kf = state.mp_obs_kf[torch.where(has, mp, torch.zeros_like(mp)).long()]  # (C, N, P)
    w = (has[..., None] & (obs_kf >= 0)).to(torch.float32).reshape(C, -1)
    covis = torch.zeros((C, K), dtype=torch.float32, device=w.device)
    covis.scatter_add_(1, torch.clamp(obs_kf, 0, K - 1).reshape(C, -1).long(), w)
    covis[torch.arange(C, device=w.device), safe] = 0.0
    nw, nid = top_k(covis, min(group_size, K))
    neigh_ok = (nw > 0) & (word_share[nid] > 0) & db.valid[nid]
    neigh_scores = torch.where(neigh_ok, scores_all[nid], torch.zeros_like(nw))
    acc = cand_scores + torch.sum(neigh_scores, dim=-1)
    grp_scores = torch.cat([cand_scores[:, None], neigh_scores], dim=-1)
    grp_ids = torch.cat([safe[:, None], nid], dim=-1)
    best_ids = torch.gather(grp_ids, 1, torch.argmax(grp_scores, dim=-1, keepdim=True))[:, 0]
    acc = torch.where(cand_ids >= 0, acc, torch.full_like(acc, -1.0))
    keep = acc > torch.clamp(0.75 * torch.max(acc), min=0.0)
    out = torch.where(keep & (cand_ids >= 0), best_ids, torch.full_like(best_ids, -1))
    return out.to(torch.int32), acc


def _detect_fused(db: DBState, state: MapState, query_bow: torch.Tensor, exclude: torch.Tensor,
                  strong_mask: torch.Tensor, n_cand: int):
    """The whole loop-candidate query: the min-score gate (the worst BoW
    score among the strongly covisible keyframes, 0.015 without any),
    stage 1 and stage 2."""
    scores = score_l1(query_bow, db.bow)
    ms = torch.where(strong_mask & db.valid, scores, torch.full_like(scores, float("inf")))
    has_strong = torch.any(strong_mask & db.valid)
    min_score = torch.where(has_strong, torch.clamp(torch.min(ms), min=1e-3),
                            torch.full((), 0.015, dtype=scores.dtype, device=scores.device))
    ids, sc, _ = _stage1(db, query_bow, exclude, min_score, n_cand)
    return _stage2(db, state, query_bow, ids, sc)


def _ordered_unique(ids, scores) -> np.ndarray:
    """Candidate ids by accumulated score (best first), deduplicated in
    order."""
    ids = np.asarray(ids)
    scores = np.asarray(scores)
    order = np.argsort(-scores)
    out, seen = [], set()
    for k in order:
        i = int(ids[k])
        if i >= 0 and i not in seen:
            seen.add(i)
            out.append(i)
    return np.asarray(out, np.int32)


def _pull(ids: torch.Tensor, acc: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    got = torch.cat([ids.to(torch.float32), acc]).cpu().numpy()
    n = ids.shape[0]
    return got[:n].astype(np.int32), got[n:]


class KeyFrameDatabase:
    """Host wrapper of the device-resident BoW matrix."""

    def __init__(self, max_keyframes: int, n_words: int, n_cand: int = 16, device="cuda"):
        self.device = resolve_device(device)
        self.db = allocate(max_keyframes, n_words, device=self.device)
        self.n_cand = n_cand

    def add(self, slot: int, bow_vec: torch.Tensor) -> None:
        self.db = add(self.db, slot, bow_vec)

    def remove(self, slot: int) -> None:
        self.db = remove(self.db, slot)

    def detect_loop_candidates_fused(self, state: MapState, query_bow: torch.Tensor,
                                     exclude: torch.Tensor, strong_mask: torch.Tensor) -> np.ndarray:
        """One query, one pull: loop candidates of a keyframe, best first."""
        return _ordered_unique(*_pull(*_detect_fused(
            self.db, state, query_bow, exclude, strong_mask, self.n_cand)))

    def detect_reloc_candidates(self, state: MapState, query_bow: torch.Tensor) -> np.ndarray:
        """Relocalization candidates: no exclusion, no score gate."""
        exclude = torch.zeros_like(self.db.valid)
        min_score = torch.full((), -1.0, device=self.device)
        ids, scores, _ = _stage1(self.db, query_bow, exclude, min_score, self.n_cand)
        if not bool(torch.any(ids >= 0)):
            return np.empty((0,), np.int32)
        return _ordered_unique(*_pull(*_stage2(self.db, state, query_bow, ids, scores)))
