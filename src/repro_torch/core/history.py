"""Term-history statistics for Starting-Pool policies (paper §7).

H(t) = frequency of term t in the preceding (read-only) index segment
(:meth:`repro_torch.core.segments.SegmentSet.history_freqs`).  The paper
notes ~7% daily churn in the top-10k terms; :func:`churn` quantifies
that on a stream.  Host-side numpy, as in the reference package.
"""
from __future__ import annotations

import numpy as np


def history_from_freqs(freqs) -> np.ndarray:
    return np.asarray(freqs, np.int64)


def _top_k(freqs: np.ndarray, k: int) -> set:
    """Canonical top-k term ids: frequency descending, ties broken by
    term id ascending (stable sort), so two frequency vectors that agree
    on the k-th value cannot disagree on WHICH tied terms are top."""
    return set(np.argsort(-freqs, kind="stable")[:k].tolist())


def churn(freqs_a, freqs_b, top_k: int = 10000) -> float:
    """Fraction of top-k terms (by frequency) in A no longer top-k in B.

    Deterministic under frequency ties: identical inputs always report
    0.0, and the selected top-k set is the lexicographically smallest
    among equal-frequency candidates.
    """
    a = np.asarray(freqs_a)
    b = np.asarray(freqs_b)
    k = min(top_k, (a > 0).sum(), (b > 0).sum())
    if k == 0:
        return 0.0
    top_a = _top_k(a, k)
    top_b = _top_k(b, k)
    return 1.0 - len(top_a & top_b) / k
