"""Analytical time/space cost model (paper §5), vectorised in numpy.

A copy of the reference package's ``core/analytical.py``: the port sizes
``max_slices`` and the slice pools with it and imports nothing from the
reference.

Implements:
  * the threshold sequence ``theta_i`` and step function ``M(f)`` (§5.1),
  * brute-force and closed-form Zipf memory cost ``C_M`` (Eq. 5 and the
    interval-counting derivation),
  * pointer counts and time cost ``C_T`` in abstract ``C_p`` units (§5.2),
  * starting-pool-aware generalisations (our extension; the paper studies
    SP policies only empirically in §7/§9.2).

Everything is exact integer math on the step function; the Zipf pieces use
float64-ish numpy on host (these run once per config, not per token).
"""
from __future__ import annotations

import math

from typing import Tuple

import numpy as np

Config = Tuple[int, ...]  # Z = (z_0, ..., z_{P-1})


# ---------------------------------------------------------------------------
# Step function M(f) and thresholds (paper §5.1)
# ---------------------------------------------------------------------------
def thetas(z: Config, n: int) -> np.ndarray:
    """First ``n+1`` thresholds theta_0..theta_n.

    theta_i = cumulative posting capacity after slice i:
      theta_0 = 2**z_0                       (pool-0 slice: no pointer slot)
      theta_i = theta_{i-1} + 2**z_i - 1     (i < P: pointer slot reserved)
      theta_i = theta_{i-1} + 2**z_{P-1} - 1 (i >= P: repeat last pool)
    """
    P = len(z)
    out = np.empty(n + 1, dtype=np.int64)
    out[0] = 1 << z[0]
    for i in range(1, n + 1):
        zz = z[i] if i < P else z[P - 1]
        out[i] = out[i - 1] + (1 << zz) - 1
    return out


def slices_needed(z: Config, f) -> np.ndarray:
    """Number of slices a term of frequency ``f`` occupies (>= 1)."""
    f = np.asarray(f, dtype=np.int64)
    fmax = int(f.max()) if f.size else 1
    th = thetas(z, _n_thetas(z, fmax))
    # smallest i with f <= theta_i  -> slices = i + 1
    i = np.searchsorted(th, np.maximum(f, 1), side="left")
    return (i + 1).astype(np.int64)


def _n_thetas(z: Config, fmax: int) -> int:
    P = len(z)
    last = (1 << z[P - 1]) - 1
    base = thetas(z, P - 1)[-1]
    extra = max(0, math.ceil(max(fmax - base, 0) / last)) + 2
    return P - 1 + extra


def memory_slots(z: Config, f) -> np.ndarray:
    """The paper's step function M(f): slots (postings + pointers).

    M(f) = theta_0 for f <= theta_0, else theta_i + i for
    theta_{i-1} < f <= theta_i  (i pointer slots for slices 1..i).
    Accepts float frequencies (the Zipf model is continuous, Eq. 5).
    """
    f = np.asarray(f)
    fmax = int(np.ceil(f.max())) if f.size else 1
    th = thetas(z, _n_thetas(z, fmax))
    i = np.searchsorted(th, np.maximum(f, 1), side="left")
    return th[i] + i


def pointer_count(z: Config, f) -> np.ndarray:
    """Slice-boundary pointer follows during a full traversal (= slices-1)."""
    return slices_needed(z, f) - 1


# ---------------------------------------------------------------------------
# Zipf memory cost C_M (paper §5.1)
# ---------------------------------------------------------------------------
def harmonic(n: int, alpha: float) -> float:
    """Generalised harmonic number H_{n,alpha} (Euler-Maclaurin for big n)."""
    if n <= 100000:
        k = np.arange(1, n + 1, dtype=np.float64)
        return float(np.sum(k ** -alpha))
    k = np.arange(1, 100001, dtype=np.float64)
    head = float(np.sum(k ** -alpha))
    a, b = 100000.0, float(n)
    if abs(alpha - 1.0) < 1e-12:
        tail = math.log(b) - math.log(a)
    else:
        tail = (b ** (1 - alpha) - a ** (1 - alpha)) / (1 - alpha)
    # trapezoid correction
    tail += 0.5 * (b ** -alpha - a ** -alpha)
    return head + tail


def zipf_freqs(vocab: int, n_tokens: int, alpha: float) -> np.ndarray:
    """Expected frequency of the rank-r term, r = 1..vocab (Eq. 4)."""
    H = harmonic(vocab, alpha)
    r = np.arange(1, vocab + 1, dtype=np.float64)
    return n_tokens * (r ** -alpha) / H


def memory_cost_bruteforce(z: Config, vocab: int, n_tokens: int,
                           alpha: float) -> float:
    """C_M by summing M(f_r) over every rank (Eq. 5, continuous Zipf f)."""
    f = zipf_freqs(vocab, n_tokens, alpha)
    return float(np.sum(memory_slots(z, f)))


def memory_cost_empirical(z: Config, freqs) -> int:
    """C_M for observed integer term frequencies (freqs > 0 only)."""
    f = np.asarray(freqs)
    f = f[f > 0]
    return int(np.sum(memory_slots(z, f.astype(np.int64))))


def memory_cost_closed_form(z: Config, vocab: int, n_tokens: int,
                            alpha: float) -> float:
    """C_M via the paper's interval-counting derivation (§5.1, last eq).

    Integer ranks are partitioned by which theta-interval their Zipf
    frequency falls into; each interval contributes (#ranks)*(theta_k + k).
    R(k) = #{r >= 1 : f(r) > theta_k} = ceil(beta * theta_k^{-1/alpha}) - 1.
    """
    H = harmonic(vocab, alpha)
    beta = (H / n_tokens) ** (-1.0 / alpha)

    fmax = max(n_tokens / H, 2.0)
    th = thetas(z, _n_thetas(z, int(fmax) + 1)).astype(np.float64)

    x = beta * th ** (-1.0 / alpha)
    R = np.clip(np.ceil(x) - 1.0, 0.0, float(vocab))
    counts = np.empty_like(th)
    counts[0] = vocab - R[0]                  # f <= theta_0 -> theta_0 slots
    counts[1:] = R[:-1] - R[1:]               # theta_{k-1} < f <= theta_k
    slots = th + np.arange(len(th))
    slots[0] = th[0]
    return float(np.sum(np.maximum(counts, 0.0) * slots))


# ---------------------------------------------------------------------------
# Time cost C_T (paper §5.2) — abstract C_p units
# ---------------------------------------------------------------------------
def time_cost(z: Config, query_term_freqs, c_p: float = 1.0) -> float:
    """C_T = sum over query-term occurrences of pointer follows * C_p."""
    f = np.asarray(query_term_freqs, dtype=np.int64)
    return float(np.sum(pointer_count(z, np.maximum(f, 1)))) * c_p


# ---------------------------------------------------------------------------
# Starting-pool-aware extension (analytical §7 counterpart)
# ---------------------------------------------------------------------------
def memory_slots_sp(z: Config, f, start_pool) -> np.ndarray:
    """M(f) when the first slice is drawn from ``start_pool`` (vectorised).

    Starting at pool s > 0 burns a pointer slot in the first slice (it
    stores NULL) but skips the small slices entirely.
    """
    f = np.asarray(f, dtype=np.int64)
    s = np.broadcast_to(np.asarray(start_pool, dtype=np.int64), f.shape)
    out = np.zeros(f.shape, dtype=np.int64)
    for sp in np.unique(s):
        zs = tuple(z[int(sp):])
        m = s == sp
        if sp == 0:
            out[m] = memory_slots(z, f[m])
        else:
            # every slice (incl. first) of the shifted config has a ptr slot
            th = thetas(zs, _n_thetas(zs, int(f[m].max()) if f[m].size else 1))
            th_sp = th - 1  # first slice also loses a slot to the NULL ptr
            i = np.searchsorted(th_sp, np.maximum(f[m], 1), side="left")
            out[m] = th_sp[i] + (i + 1)
    return out


def config_space(slice_range=(0, 12), pools_range=(4, 8),
                 max_configs: int | None = None):
    """Yield strictly-increasing Z configs (paper §6 search space)."""
    import itertools
    lo, hi = slice_range
    count = 0
    for P in range(pools_range[0], pools_range[1] + 1):
        for z in itertools.combinations(range(lo, hi + 1), P):
            yield z
            count += 1
            if max_configs is not None and count >= max_configs:
                return
