"""Mixture-of-Experts FFN: top-k routing with sort-based capacity
dispatch (the reference's ``models/moe.py``).

Dispatch, as in the reference:
  1. router -> top-k experts per token (fp32 softmax, renormalised
     gates; on a tie the lower expert id wins, as ``lax.top_k`` orders);
  2. flatten the (token, k) pairs and sort them by expert id (stable);
  3. rank within expert from the group starts; a pair ranked past the
     capacity C = cf * T * k / E is dropped (GShard-style);
  4. gather the tokens into [E, C, d] (an empty slot reads a zero row),
     run the experts' SwiGLU as batched matmuls, and scatter-add the
     outputs back weighted by the gates, in fp32.

The fp32 scatter-add of a token's k expert outputs has no fixed order on
CUDA (``index_add_``): results agree with the reference within a
tolerance, not bit for bit.  :func:`moe_layer_specs` gives the
reference's logical specs, and the dispatch calls ``constrain`` at the
reference's places (a no-op on one device).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L


def init_moe_layer(cfg: LMConfig, gen: torch.Generator,
                   device=None) -> dict:
    """One layer's MoE parameters: the router in fp32 whatever
    ``param_dtype`` says, ``moe_ep_pad`` experts (padded experts are
    never routed to) and, with shared experts, one fused shared SwiGLU."""
    dt = getattr(torch, cfg.param_dtype)
    d, fe = cfg.d_model, cfg.moe_d_ff
    E = cfg.moe_ep_pad or cfg.n_experts

    def dense(shape, dtype=dt, scale=None):
        return L.dense_init(gen, shape, dtype, scale, device=device)

    p = {
        "router": dense((d, E), torch.float32),
        "experts": {
            "w_gate": dense((E, d, fe)),
            "w_up": dense((E, d, fe)),
            "w_down": dense((E, fe, d), scale=fe ** -0.5),
        },
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p["shared"] = {
            "w_gate": dense((d, fs)),
            "w_up": dense((d, fs)),
            "w_down": dense((fs, d), scale=fs ** -0.5),
        }
    return p


def moe_layer_specs(cfg: LMConfig, mesh_model_size: int | None = None) -> dict:
    """Logical specs.  Experts go to 'model' (EP) when the expert count is
    model-divisible (by 16 when no mesh size is given); otherwise the ffn
    dim shards (TP within each expert)."""
    ep = (cfg.moe_ep_pad or cfg.n_experts) % (mesh_model_size or 16) == 0
    if ep:
        experts = {
            "w_gate": ("model", "fsdp", None),
            "w_up": ("model", "fsdp", None),
            "w_down": ("model", None, "fsdp"),
        }
    else:
        experts = {
            "w_gate": (None, "fsdp", "model"),
            "w_up": (None, "fsdp", "model"),
            "w_down": (None, "model", "fsdp"),
        }
    s = {"router": (None, None), "experts": experts}
    if cfg.n_shared_experts:
        s["shared"] = {
            "w_gate": ("fsdp", "model"),
            "w_up": ("fsdp", "model"),
            "w_down": ("model", "fsdp"),
        }
    return s


def _capacity(cfg: LMConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.moe_top_k / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def moe_ffn(x, p, cfg: LMConfig):
    """Token-dropping top-k MoE.

    x: [G, T, d] (grouped: routing, sort and capacity per group) or
    [T, d] (one group).  Returns (y of x's shape and dtype, metrics with
    ``aux_loss`` and ``drop_fraction``)."""
    if x.dim() == 3:
        return _moe_ffn_grouped(x, p, cfg)
    return _moe_ffn_tokens(x, p, cfg)


def _route(x, router, cfg: LMConfig):
    """fp32 routing over the first ``n_experts`` columns: (probs [..., E],
    gate [..., k] renormalised, expert [..., k] int64)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    logits = x.float() @ router.float()
    probs = torch.softmax(logits[..., :E], dim=-1)
    # a stable descending sort keeps the lower expert id first on a tie
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[..., :k], expert[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


def _dispatch(expert, gate, C: int, E: int):
    """Slot maps of one or more groups over ``E`` experts' ``C`` slots
    each.  expert/gate: [G, T, k].

    Returns (slot_tok int64 [G, E * C]: the token in each slot, T for an
    empty one; slot_gate fp32 [G, E * C]; keep bool [G, T * k], in
    expert-sorted order)."""
    G, T, k = expert.shape
    dev = expert.device
    e_flat = expert.reshape(G, T * k)
    t_flat = torch.arange(T, device=dev).repeat_interleave(k).expand(G, -1)
    g_flat = gate.reshape(G, T * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_s = torch.gather(e_flat, 1, order)
    t_s = torch.gather(t_flat, 1, order)
    g_s = torch.gather(g_flat, 1, order)
    starts = torch.searchsorted(
        e_s.contiguous(),
        torch.arange(E, device=dev).expand(G, -1).contiguous())   # [G, E]
    rank = torch.arange(T * k, device=dev)[None] - torch.gather(starts, 1, e_s)
    keep = rank < C
    dest = torch.where(keep, e_s * C + rank, E * C)              # sentinel
    # the sentinel column E * C takes every dropped pair and is cut off
    # (out of place: a DTensor scatter cannot write into a plain tensor)
    slot_tok = torch.full((G, E * C + 1), T, dtype=torch.int64,
                          device=dev).scatter(1, dest, t_s)
    slot_gate = torch.zeros((G, E * C + 1), dtype=torch.float32,
                            device=dev).scatter(1, dest, g_s)
    return slot_tok[:, :-1], slot_gate[:, :-1], keep


def _experts(x, slot_tok, slot_gate, we, n_e: int, C: int,
             grouped: bool = False):
    """Gather, the experts' SwiGLU and the weighted scatter back, for G
    groups at once.  x: [G, T, d]; slot maps [G, n_e * C].  Returns fp32
    [G, T, d].  ``grouped``: the groups are the batch, and the [E, G*C,
    ...] activations take the reference's batch and ffn annotations (its
    [G, E, C, ...] layout has G outermost, as G*C has here)."""
    G, T, d = x.shape
    dev = x.device

    def annotate(t, *logical):
        return constrain(t, *logical) if grouped else t

    # one flat [G * (T + 1), d] source whose row T of each group is zero
    x_pad = torch.cat([x, x.new_zeros(G, 1, d)], 1).reshape(-1, d)
    rows = slot_tok + torch.arange(G, device=dev)[:, None] * (T + 1)
    rows = rows.reshape(G, n_e, C).transpose(0, 1).reshape(n_e, G * C)
    xe = annotate(x_pad[rows], None, "batch", None)              # [E, G*C, d]
    h = F.silu(torch.bmm(xe, we["w_gate"])) * torch.bmm(xe, we["w_up"])
    h = annotate(h, None, "batch", "model")
    ye = annotate(torch.bmm(h, we["w_down"]), None, "batch", None)
    gates = slot_gate.reshape(G, n_e, C).transpose(0, 1).reshape(-1, 1)
    y = torch.zeros((G * (T + 1), d), dtype=torch.float32,
                    device=dev).index_add(0, rows.reshape(-1),
                                          ye.reshape(-1, d).float() * gates)
    return y.reshape(G, T + 1, d)[:, :T]


def _metrics(probs, expert, keep, E: int, n_pairs: int) -> dict:
    lead = tuple(range(expert.dim() - 1))
    density = F.one_hot(expert, E).float().mean(dim=lead + (expert.dim() - 1,))
    mean_probs = probs.mean(dim=lead)
    return {"aux_loss": E * torch.sum(density * mean_probs),
            "drop_fraction": 1.0 - keep.sum() / n_pairs}


def _moe_ffn_grouped(x, p, cfg: LMConfig):
    """x: [G, T, d]; buffers sized to the padded expert count."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    Ep = cfg.moe_ep_pad or E
    C = _capacity(cfg, T)
    probs, gate, expert = _route(x, p["router"], cfg)
    slot_tok, slot_gate, keep = _dispatch(expert, gate, C, Ep)
    slot_tok = constrain(slot_tok, "batch", None)
    slot_gate = constrain(slot_gate, "batch", None)
    y = _experts(x, slot_tok, slot_gate, p["experts"], Ep, C, grouped=True)
    y = constrain(y.to(x.dtype), "batch", None, None)
    if cfg.n_shared_experts:
        y = y + L.swiglu(x, **p["shared"])
    return y, _metrics(probs, expert, keep, E, G * T * k)


def _moe_ffn_tokens(x, p, cfg: LMConfig):
    """x: [T, d] -> ([T, d], metrics).  One dispatch group, buffers sized
    to ``n_experts`` (the reference's single-group path)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    C = _capacity(cfg, T)
    probs, gate, expert = _route(x, p["router"], cfg)
    slot_tok, slot_gate, keep = _dispatch(expert[None], gate[None], C, E)
    y = _experts(x[None], slot_tok, slot_gate, p["experts"], E, C)[0]
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + L.swiglu(x, **p["shared"])
    return y, _metrics(probs, expert, keep, E, T * k)
