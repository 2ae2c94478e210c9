"""Step factories per architecture family (the reference's
``train/steps.py``): the LM and recsys train steps, the LM prefill and
decode steps, the recsys forward and retrieval steps, and parameter init
by family.

Each factory closes over the config (and the optimizer) and returns a
plain function of (params, ...) that runs where the parameters are;
PyTorch runs it eagerly.  A train step is the reference's: gradients by
autograd (``torch.autograd.grad``), microbatches split along the leading
axis and their gradients summed in ``grad_accum_dtype`` (fp32), loss and
gradients scaled by 1/n, then an optional ``grad_transform`` and the
optimizer's pure update.  With one microbatch the gradients stay in the
parameters' dtype, as the reference's do.  The GNN train step waits for
``models/schnet.py`` (ROADMAP.md Queue 1 item 12 part 4) and raises.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import LMConfig, RecsysConfig
from repro_torch.kernels import ops
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW, AdamWState, global_norm


def make_gnn_train_step(*args, **kwargs):
    raise NotImplementedError(
        "make_gnn_train_step: SchNet is not ported yet (ROADMAP.md Queue 1 "
        "item 12 part 4)")


# ---------------------------------------------------------------------------
# Gradients and the update
# ---------------------------------------------------------------------------
def _value_and_grad(loss_fn, params, batch):
    """``(loss, grads)``: the loss detached, one gradient per parameter
    leaf in its dtype (zeros where the loss does not reach it)."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def _accumulate_grads(loss_fn, params, batches, n_micro: int,
                      accum_dtype=torch.float32):
    """Microbatches in order; returns (mean loss, gradient tree)."""
    if n_micro == 1:
        return _value_and_grad(loss_fn, params, batches)

    def split(x):
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"{n_micro} microbatches")
        return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])

    parts = tree.tree_map(split, batches)
    acc_loss = torch.zeros((), dtype=torch.float32,
                           device=tree.leaves(params)[0].device)
    acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
           for p in tree.leaves(params)]
    for i in range(n_micro):
        loss, grads = _value_and_grad(
            loss_fn, params, tree.tree_map(lambda x: x[i], parts))
        for a, g in zip(acc, tree.leaves(grads)):
            a += g.to(accum_dtype)
        del grads
        acc_loss = acc_loss + loss
    inv = 1.0 / n_micro
    return acc_loss * inv, tree.unflatten(params, [a * inv for a in acc])


def _apply(opt: AdamW, params, opt_state, grads, grad_transform=None):
    if grad_transform is not None:
        grads, opt_state = grad_transform(grads, opt_state)
    return opt.update(grads, opt_state, params)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------
def make_lm_train_step(cfg: LMConfig, opt: AdamW, *, n_microbatches=None,
                       q_chunk: int = 512, grad_accum_dtype=torch.float32,
                       grad_transform=None) -> Callable:
    """``train_step(params, opt_state, tokens [B, S]) -> (params,
    opt_state, {"loss", "grad_norm"})`` (fp32 scalars on the device)."""
    n_micro = n_microbatches or cfg.n_microbatches

    def loss_fn(params, tokens):
        return T.lm_loss(params, tokens, cfg, q_chunk=q_chunk)

    def train_step(params, opt_state: AdamWState, tokens):
        loss, grads = _accumulate_grads(loss_fn, params, tokens, n_micro,
                                        grad_accum_dtype)
        gnorm = global_norm(grads)
        params, opt_state = _apply(opt, params, opt_state, grads,
                                   grad_transform)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


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


def make_recsys_train_step(cfg: RecsysConfig, opt: AdamW,
                           n_microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})``: the forward's logits under ``bce_loss`` against
    ``batch["label"]``; every table read backpropagates through
    ``ops.embedding_bag`` (on the card, the ``embedding_bag_backward``
    kernel)."""
    _, fwd = R.FORWARDS[cfg.interaction]
    offsets = {}

    def loss_fn(params, batch):
        dev = params["table"].device
        if dev not in offsets:
            offsets[dev] = R.field_offsets(cfg.vocab_sizes, dev)
        logits = fwd(params, _recsys_batch(batch), cfg, offsets[dev])
        return R.bce_loss(logits, batch["label"])

    def train_step(params, opt_state, batch):
        loss, grads = _accumulate_grads(loss_fn, params, batch,
                                        n_microbatches)
        params, opt_state = _apply(opt, params, opt_state, grads)
        return params, opt_state, {"loss": loss}

    return train_step


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
