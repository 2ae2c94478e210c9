"""Stateless-resumable LM token pipeline (the reference's
``data/lm_data.py``).

A batch is a pure function of (seed, step): after a failure the restored
step re-generates exactly the batches that would have been consumed, so
the pipeline needs no checkpoint of its own.  Tokens are Zipf(alpha),
the statistics the paper's postings study assumes.

The uniforms come from a ``torch.Generator`` seeded from (seed, step),
so the batches are not the reference's (its ``fold_in`` stream cannot
be reproduced); the Zipf CDF and the map from a uniform to a token
(``searchsorted``, then clipped to the vocabulary) are the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int
    seq_len: int
    alpha: float = 1.0
    seed: int = 0


def _zipf_cdf(vocab: int, alpha: float) -> np.ndarray:
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -alpha
    p /= p.sum()
    return np.cumsum(p)


def tokens_from_uniform(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Token ids int32 for uniforms ``u`` under the fp32 ``cdf`` (the
    first index whose CDF is >= u, clipped to the vocabulary)."""
    toks = torch.searchsorted(cdf, u).to(torch.int32)
    return torch.clamp(toks, 0, cdf.shape[0] - 1)


def _step_seed(seed: int, step: int) -> int:
    """One 64-bit generator seed from (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def make_batch_fn(cfg: LMDataConfig, device="cuda"):
    """``batch_at(step) -> int32 [batch, seq_len]`` on ``device``."""
    cdf = torch.as_tensor(_zipf_cdf(cfg.vocab, cfg.alpha),
                          dtype=torch.float32, device=device)

    def batch_at(step: int) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(_step_seed(cfg.seed, int(step)))
        u = torch.rand((cfg.batch, cfg.seq_len), generator=gen,
                       device=device)
        return tokens_from_uniform(cdf, u)

    return batch_at


def batches(cfg: LMDataConfig, start_step: int, n_steps: int,
            device="cuda"):
    fn = make_batch_fn(cfg, device=device)
    for s in range(start_step, start_step + n_steps):
        yield fn(s)
