"""Step factories per architecture family (the reference's
``train/steps.py``): the LM, GNN and recsys train steps, the LM prefill
and decode steps, the GNN and recsys forwards, the recsys retrieval
step, and parameter init by family.

Each factory closes over the config (and the optimizer) and returns a
plain function of (params, ...) that runs where the parameters are;
PyTorch runs it eagerly.  A train step is the reference's: gradients by
autograd (``torch.autograd.grad``), microbatches split along the leading
axis and their gradients summed in ``grad_accum_dtype`` (fp32), loss and
gradients scaled by 1/n, then an optional ``grad_transform`` and the
optimizer's pure update.  With one microbatch the gradients stay in the
parameters' dtype, as the reference's do.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.dist.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import schnet as G
from repro_torch.models import transformer as T
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW, AdamWState, global_norm


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
    grads = [torch.zeros_like(p) if g is None else _laid_out_as(g, p)
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def _laid_out_as(g, p):
    """A ``DTensor`` gradient redistributed to its parameter's placements
    (the gradient reduction over the data dims that a sharded step needs,
    and over any dim an op's strategy split the batch on); where
    ``DTensor``'s collectives would send a CUDA tensor over gloo (ranks
    sharing a card), by the staged family instead
    (``dist.collectives.local_as``); a plain tensor as it is."""
    placements = getattr(p, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import collectives as C
    if not C.staged_for(g):
        return g.redistribute(p.device_mesh, placements)
    return DTensor.from_local(C.local_as(g, placements), p.device_mesh,
                              placements, run_check=False, shape=g.shape,
                              stride=g.stride())


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
    acc = [torch.zeros_like(p, dtype=accum_dtype,
                            memory_format=torch.contiguous_format)
           for p in tree.leaves(params)]
    for i in range(n_micro):
        # each microbatch batch-sharded again (a no-op without rules: a
        # sharded batch's rows of one microbatch lie on a few ranks)
        loss, grads = _value_and_grad(loss_fn, params, tree.tree_map(
            lambda x: constrain(x[i], "batch", *(None,) * (x.dim() - 2)),
            parts))
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
        # the argmax over the whole vocab (a no-op on one device; DTensor's
        # argmax over a vocab-sharded dim is not used)
        whole = constrain(logits, "batch", None)
        next_tok = torch.argmax(whole, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache
    return decode_step


# ---------------------------------------------------------------------------
# GNN (SchNet)
# ---------------------------------------------------------------------------
def _graph_batch(batch: dict, n_graphs: int) -> G.GraphBatch:
    return G.GraphBatch(
        node_feat=batch.get("node_feat"), atom_type=batch.get("atom_type"),
        src=batch["src"], dst=batch["dst"], edge_dist=batch["edge_dist"],
        graph_id=batch["graph_id"], n_graphs=n_graphs)


def make_gnn_train_step(cfg: GNNConfig, opt: AdamW,
                        n_graphs: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})``: ``schnet_loss`` of the batch dict (``src``, ``dst``,
    ``edge_dist``, ``graph_id``, ``targets`` [n_graphs], and
    ``node_feat`` or ``atom_type``) and one optimizer update, where the
    parameters are."""
    def loss_fn(params, batch):
        return G.schnet_loss(params, _graph_batch(batch, n_graphs),
                             batch["targets"], cfg)

    def train_step(params, opt_state, batch):
        loss, grads = _value_and_grad(loss_fn, params, batch)
        params, opt_state = _apply(opt, params, opt_state, grads)
        return params, opt_state, {"loss": loss}

    return train_step


def make_gnn_forward(cfg: GNNConfig, n_graphs: int = 1,
                     device="cuda") -> Callable:
    """``forward(params, batch) -> (per-node outputs [N, n_out],
    per-graph readout [n_graphs, n_out])`` for a batch dict of tensors on
    ``device`` (the radial-basis centres are made there once)."""
    centers = G.rbf_centers(cfg.n_rbf, cfg.cutoff, device)

    def forward(params, batch):
        return G.schnet_forward(params, _graph_batch(batch, n_graphs), cfg,
                                centers)
    return forward


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
    fwd = R.FORWARDS[cfg.interaction][1]
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
    fwd = R.FORWARDS[cfg.interaction][1]
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
                    device="cuda", table_rows=None):
    """Random parameters of ``cfg`` (the reference's shapes, dtypes and
    scales; its ``jax.random`` stream is not reproduced, so tests carry
    a reference tree across with ``core.convert``).  SchNet's input
    width is ``shape_spec``'s ``d_feat`` (else ``cfg.d_feat_default``).
    A recsys tree with ``table_rows=(lo, hi)`` holds those rows of its
    tables alone (one rank's block; ``models.recsys.init_table``), every
    other leaf the whole tree's."""
    fam = arch_entry.family
    if table_rows is not None and fam in ("lm", "gnn"):
        raise ValueError(f"init_params_for: table_rows is for recsys "
                         f"tables, not the {fam} family")
    if fam == "lm":
        return T.init_lm(cfg, seed=seed, device=device)
    gen = L.make_generator(device, seed)
    if fam == "gnn":
        d_feat = (shape_spec.extra("d_feat", cfg.d_feat_default)
                  if shape_spec is not None else cfg.d_feat_default)
        return G.init_schnet(cfg, gen, d_feat=d_feat, device=device)
    init = R.FORWARDS[cfg.interaction][0]
    return init(cfg, gen, device, table_rows=table_rows)


def param_specs_for(arch_entry, cfg, mesh_model_size: int = 16):
    """Logical specs of :func:`init_params_for`'s tree.  The LM's expert
    rule never sees ``mesh_model_size`` (the reference's
    ``lm_param_specs`` does not pass it on)."""
    fam = arch_entry.family
    if fam == "lm":
        return T.lm_param_specs(cfg)
    if fam == "gnn":
        return G.schnet_param_specs(cfg)
    return R.FORWARDS[cfg.interaction][2](cfg)
