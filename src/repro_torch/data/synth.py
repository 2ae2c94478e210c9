"""Synthetic corpus + query-log facsimiles (paper §4).

Tweets2011 / the AOL, TREC-terabyte and TREC-microblog query logs are not
redistributable offline, so we generate calibrated stand-ins:

  * :func:`zipf_corpus` — a tweet stream whose term distribution is
    Zipf(alpha) with the paper's fitted alpha = 1.0; document lengths follow
    the short-text profile (tweets average ~11 terms, capped at 70 terms /
    140 chars).
  * :func:`query_log` — query sets whose *postings-length distributions*
    mimic the paper's Figure 2: "aol"/"terabyte" are nearly identical and
    log-uniform-heavy at both extremes; "microblog" de-emphasises the very
    common and very rare tails.

Every benchmark that quotes Table 1/2 numbers validates orderings/ratios
against the paper, never absolute milliseconds (DESIGN.md §7).

A numpy copy of the reference package's ``data/synth.py``: the same
seeds give the same corpora and query logs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    vocab: int = 100_000
    n_docs: int = 50_000
    mean_len: int = 11
    max_len: int = 70
    alpha: float = 1.0
    seed: int = 0


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** -alpha
    return p / p.sum()


def zipf_corpus(spec: CorpusSpec) -> np.ndarray:
    """int32[n_docs, max_len] term-id matrix padded with -1.

    Term ids are Zipf ranks shuffled (rank != id) so that frequency is not
    trivially recoverable from the id — mirrors a real dictionary.
    """
    rng = np.random.default_rng(spec.seed)
    probs = _zipf_probs(spec.vocab, spec.alpha)
    perm = rng.permutation(spec.vocab)
    lens = np.clip(rng.poisson(spec.mean_len, spec.n_docs), 1, spec.max_len)
    docs = np.full((spec.n_docs, spec.max_len), -1, np.int32)
    total = int(lens.sum())
    draws = perm[rng.choice(spec.vocab, size=total, p=probs)]
    # row-major fill of each doc's first lens[i] columns, in draw order:
    # the same matrix as a per-doc loop, without 2**23 Python steps
    docs[np.arange(spec.max_len)[None, :] < lens[:, None]] = draws
    return docs


def corpus_halves(spec: CorpusSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Chronological split: first half for history, second for experiments
    (paper §8)."""
    docs = zipf_corpus(spec)
    h = spec.n_docs // 2
    return docs[:h], docs[h:]


def term_freqs(docs: np.ndarray, vocab: int) -> np.ndarray:
    flat = docs[docs >= 0]
    return np.bincount(flat, minlength=vocab).astype(np.int64)


def query_log(kind: str, n_queries: int, docs: np.ndarray, vocab: int,
              seed: int = 1, max_terms: int = 4) -> np.ndarray:
    """int32[n_queries, max_terms] padded with -1.

    Sampling matches Figure 2's shape: query terms are drawn by target
    postings-length decile rather than uniformly, so head/torso/tail mix
    differs per log kind.
    """
    rng = np.random.default_rng(seed)
    freqs = term_freqs(docs, vocab)
    seen = np.nonzero(freqs)[0]
    order = seen[np.argsort(-freqs[seen])]  # descending frequency:
    # idx 0 = most frequent term, so log-uniform rank sampling is
    # head-heavy (real query logs skew to frequent terms) with a long
    # tail — paper Fig 2'stwo-extremes shape.
    n = len(order)

    if kind in ("aol", "terabyte"):
        # log-uniform over frequency ranks: heavy at both extremes.
        u = rng.random(n_queries * max_terms)
        idx = (n - 1) * (np.exp(u * np.log(n)) - 1) / (n - 1)
        idx = np.clip(idx.astype(np.int64), 0, n - 1)
    elif kind == "microblog":
        # beta-shaped: de-emphasise extremes (paper Fig 2).
        u = rng.beta(2.2, 2.2, n_queries * max_terms)
        idx = np.clip((u * (n - 1)).astype(np.int64), 0, n - 1)
    else:
        raise ValueError(f"unknown query log kind {kind!r}")

    terms = order[idx].reshape(n_queries, max_terms).astype(np.int32)
    # query lengths: AOL-like distribution, mean ~2.3 terms.
    lens = np.clip(rng.geometric(0.45, n_queries), 1, max_terms)
    for j in range(max_terms):
        terms[lens <= j, j] = -1
    return terms


def query_term_freqs(queries: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """Postings lengths for every query-term occurrence (Fig 2 x-axis)."""
    t = queries[queries >= 0]
    return freqs[t]
