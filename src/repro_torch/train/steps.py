"""Step factories per architecture family (the reference's
``train/steps.py``), serving part: the LM prefill and decode steps, the
recsys forward and retrieval steps, and parameter init by family.

Each factory closes over the config and the device and returns a plain
function of (params, batch); PyTorch runs it eagerly.  The train steps
(LM, GNN and recsys, with the optimizer, microbatching and gradient
compression) wait for the training slice (ROADMAP.md Queue 1 item 12)
and raise.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import LMConfig, RecsysConfig
from repro_torch.kernels import ops
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T

_TRAINING = ("training is not ported yet (ROADMAP.md Queue 1 item 12); "
             "the port serves recsys models and LMs")


def make_lm_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_lm_train_step: {_TRAINING}")


def make_gnn_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_gnn_train_step: {_TRAINING}")


def make_recsys_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_recsys_train_step: {_TRAINING}")


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------
def make_lm_prefill_step(cfg: LMConfig, q_chunk: int = 512) -> Callable:
    """``prefill_step(params, tokens [B, S]) -> (logits fp32 [B, V],
    DecodeCache)``."""
    def prefill_step(params, tokens):
        return T.lm_prefill(params, tokens, cfg, q_chunk=q_chunk)
    return prefill_step


def make_lm_decode_step(cfg: LMConfig) -> Callable:
    """``decode_step(params, cache, token [B, 1], pos) -> (next token
    int32 [B, 1] (the argmax), logits fp32 [B, V], cache)``; the cache
    is updated in place."""
    def decode_step(params, cache: T.DecodeCache, token, pos):
        logits, cache = T.lm_decode_step(params, cache, token, pos, cfg)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache
    return decode_step


# ---------------------------------------------------------------------------
# Recsys
# ---------------------------------------------------------------------------
def _recsys_batch(batch: dict) -> R.RecsysBatch:
    return R.RecsysBatch(
        dense=batch.get("dense"), sparse=batch["sparse"],
        label=batch.get("label"), hist=batch.get("hist"),
        hist_len=batch.get("hist_len"))


def make_recsys_forward(cfg: RecsysConfig, device="cuda") -> Callable:
    """``forward(params, batch) -> logits [B]`` for a batch dict of
    tensors on ``device`` (``sparse``, and ``dense`` or ``hist`` /
    ``hist_len`` as the arch needs)."""
    _, fwd = R.FORWARDS[cfg.interaction]
    offsets = R.field_offsets(cfg.vocab_sizes, device)

    def forward(params, batch: dict):
        return fwd(params, _recsys_batch(batch), cfg, offsets)

    return forward


def make_recsys_retrieval_step(cfg: RecsysConfig, device="cuda") -> Callable:
    """``retrieval_step(params, user_sparse [1, F], cand_ids [N]) ->
    scores [N]``: the user vector is the mean of the user's F field rows
    (one mean-bag), scored against N candidate rows."""
    offsets = R.field_offsets(cfg.vocab_sizes, device)

    def retrieval_step(params, user_sparse, cand_ids):
        table = params["table"]
        user = (user_sparse[0] + offsets).to(torch.int32)
        csr = torch.tensor([0, user.shape[0]], dtype=torch.int32,
                           device=table.device)
        user_vec = ops.embedding_bag(table, user, csr, "mean")[0]
        return R.retrieval_scores(table, user_vec, cand_ids)

    return retrieval_step


# ---------------------------------------------------------------------------
# Family-level dispatch
# ---------------------------------------------------------------------------
def init_params_for(arch_entry, cfg, seed: int = 0, shape_spec=None,
                    device="cuda"):
    """Random parameters of ``cfg`` (the reference's shapes, dtypes and
    scales; its ``jax.random`` stream is not reproduced, so tests carry
    a reference tree across with ``core.convert``)."""
    fam = arch_entry.family
    if fam == "lm":
        return T.init_lm(cfg, seed=seed, device=device)
    if fam != "recsys":
        raise NotImplementedError(f"{fam}: not ported yet (ROADMAP.md "
                                  f"Queue 1 item 12)")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init, _ = R.FORWARDS[cfg.interaction]
    return init(cfg, gen)
