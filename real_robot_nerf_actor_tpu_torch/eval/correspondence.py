"""Dense-feature correspondence matching (the port's copy of the JAX
package's `eval/correspondence.py`): match query pixels between two
images by the cosine similarity of their dense features."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def find_correspondences(feat_a: np.ndarray, feat_b: np.ndarray,
                         query_yx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """feat_a / feat_b: (Ha, Wa, D) / (Hb, Wb, D); query_yx: (N, 2) integer
    pixels of A. Returns (matches_yx (N, 2) in B, similarity (N,))."""
    fa = np.asarray(feat_a, np.float32)
    fb = np.asarray(feat_b, np.float32)
    hb, wb, d = fb.shape
    q = fa[query_yx[:, 0], query_yx[:, 1]]
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-8)
    flat = fb.reshape(-1, d)
    flat = flat / (np.linalg.norm(flat, axis=-1, keepdims=True) + 1e-8)
    sim = q @ flat.T
    best = np.argmax(sim, axis=-1)
    matches = np.stack([best // wb, best % wb], axis=-1)
    return matches, sim[np.arange(len(best)), best]


def cycle_consistency(feat_a: np.ndarray, feat_b: np.ndarray,
                      query_yx: np.ndarray, tol: int = 1) -> float:
    """Share of queries whose A -> B -> A round trip lands within `tol`
    pixels."""
    m_ab, _ = find_correspondences(feat_a, feat_b, query_yx)
    m_aba, _ = find_correspondences(feat_b, feat_a, m_ab)
    err = np.abs(m_aba - query_yx).max(axis=-1)
    return float((err <= tol).mean())
