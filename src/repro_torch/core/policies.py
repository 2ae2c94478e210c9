"""Starting Pool (SP) allocation policies (paper §7).

Each policy maps a term's historical frequency ``H(t)`` (from the previous,
now read-only, index segment) to the pool index its FIRST slice should come
from.  Out-of-vocabulary terms (H == 0 here) always start at pool 0.

Policies (paper notation):
  * ``sp_default``  — SP(z_0): ignore history, start at pool 0.
  * ``sp_ceil``     — SP(ceil(H)): smallest slice size larger than H.
  * ``sp_floor``    — SP(floor(H)): largest slice size smaller than H.
  * ``sp_lambda``   — SP(Lambda(H, z_{P-1})): last pool iff H >= 2**z_{P-1},
                      else pool 0 ("long vs short" split).

Tables are int64 tensors on ``device`` (``searchsorted`` and the ingest
gather take no uint32 in torch); the values are the reference's uint32
pool indices.  The reference runs with 64-bit types off, so its int64
history is int32 there: compare values, not dtypes.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def _hist(hist, device) -> torch.Tensor:
    if not isinstance(hist, torch.Tensor):
        hist = torch.as_tensor(hist)
    return hist.to(device=device, dtype=torch.int64)


def _sizes(z: Tuple[int, ...], device) -> torch.Tensor:
    return torch.tensor([1 << zz for zz in z], dtype=torch.int64,
                        device=device)


def sp_default(z: Tuple[int, ...], hist, device="cuda") -> torch.Tensor:
    return torch.zeros_like(_hist(hist, device))


def sp_ceil(z: Tuple[int, ...], hist, device="cuda") -> torch.Tensor:
    """The pool whose slice size is the smallest >= H (the last pool if H
    exceeds all): pool p iff 2**z_{p-1} < H <= 2**z_p."""
    h = _hist(hist, device)
    p = torch.searchsorted(_sizes(z, h.device), h, side="left")
    p = p.clamp(max=len(z) - 1)
    return torch.where(h > 0, p, 0)


def sp_floor(z: Tuple[int, ...], hist, device="cuda") -> torch.Tensor:
    """Largest slice size <= H (pool 0 if H below all; last pool capped)."""
    h = _hist(hist, device)
    p = torch.searchsorted(_sizes(z, h.device), h, side="right") - 1
    p = p.clamp(0, len(z) - 1)
    return torch.where(h > 0, p, 0)


def sp_lambda(z: Tuple[int, ...], hist, device="cuda") -> torch.Tensor:
    h = _hist(hist, device)
    return torch.where(h >= (1 << z[-1]), len(z) - 1, 0).to(torch.int64)


POLICIES: Dict[str, Callable] = {
    "sp_default": sp_default,
    "sp_ceil": sp_ceil,
    "sp_floor": sp_floor,
    "sp_lambda": sp_lambda,
}


def start_pools_for_vocab(policy: str, z: Tuple[int, ...], history_freqs,
                          device="cuda") -> torch.Tensor:
    """Precompute a per-term starting-pool table from a history table."""
    return POLICIES[policy](z, history_freqs, device=device)
