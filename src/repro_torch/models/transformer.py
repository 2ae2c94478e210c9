"""Decoder-only transformer LM: dense and MoE layers, local/global
(Gemma3-style) attention, the full-sequence forward, the loss, prefill
and decode with a KV cache (the reference's ``models/transformer.py``).

Parameters are a plain dict with the reference's tree names; each layer
stack (``layers``, or ``local_layers`` and ``global_layers`` when
``local_global_ratio`` is set) holds ``[L, ...]`` tensors, one leading
slice per layer, and the layers run in a Python loop where the
reference scans.  Attention over a full sequence is q-chunked with fp32
logits (``chunked_attention``); a local layer's decode cache is a ring
buffer of ``sliding_window`` slots; with ``kv_quant`` the cache is int8
with a per-(token, head) fp32 scale.  MoE layers dispatch through
:mod:`repro_torch.models.moe`.

There is one device, so the reference's sharding constraints and specs
are gone (ROADMAP.md Queue 1 item 12.6).  With ``cfg.remat``, autograd
on and parameters that need a gradient, ``lm_forward`` runs each block
under ``torch.utils.checkpoint.checkpoint`` (the reference's
``jax.checkpoint``), so a block's attention logits are recomputed in the
backward instead of kept; it takes each stack's layers by one
``unbind``, so the backward stacks a leaf's layer gradients once.  The
decode cache is updated in place.  The dense decode is the oracle the
paged decode of :mod:`repro_torch.paged.serve_model` is held against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def dtype_of(name: str) -> torch.dtype:
    """torch dtype of a config's dtype name (``"float32"``, ...)."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(cfg: LMConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg.param_dtype)
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    p = {
        "attn_norm": torch.zeros((d,), dtype=dt, device=gen.device),
        "mlp_norm": torch.zeros((d,), dtype=dt, device=gen.device),
        "wq": L.dense_init(gen, (d, hq * dh), dt),
        "wk": L.dense_init(gen, (d, hkv * dh), dt),
        "wv": L.dense_init(gen, (d, hkv * dh), dt),
        "wo": L.dense_init(gen, (hq * dh, d), dt),
    }
    if cfg.moe:
        p["moe"] = M.init_moe_layer(cfg, gen)
    else:
        p["mlp"] = {"w_gate": L.dense_init(gen, (d, f), dt),
                    "w_up": L.dense_init(gen, (d, f), dt),
                    "w_down": L.dense_init(gen, (f, d), dt)}
    return p


def _stack_init(cfg: LMConfig, gen: torch.Generator, n: int) -> dict:
    """``n`` layers' parameters stacked ``[n, ...]``, drawn one layer at a
    time (the reference vmaps ``_init_layer``), so the fp32 draw is one
    layer's, never the stack's: Qwen2-MoE's expert stack would be 16.6 GB
    in fp32."""
    first = _init_layer(cfg, gen)

    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        out = torch.empty((n,) + tuple(node.shape), dtype=node.dtype,
                          device=node.device)
        out[0] = node
        return out

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    stack = alloc(first)
    del first
    for i in range(1, n):
        put(stack, _init_layer(cfg, gen), i)
    return stack


def _n_local_global(cfg: LMConfig) -> Tuple[int, int]:
    """(local layers, global layers): ``local_global_ratio`` r tiles the
    depth as groups of r local layers and one global."""
    r = cfg.local_global_ratio
    if r <= 0:
        return 0, cfg.n_layers
    if cfg.n_layers % (r + 1):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not tile "
                         f"(local^{r}, global)")
    n_groups = cfg.n_layers // (r + 1)
    return n_groups * r, n_groups


def init_lm(cfg: LMConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the shapes, dtypes and scales of the
    reference's ``init_lm`` (its ``jax.random`` stream cannot be
    reproduced; :func:`repro_torch.core.convert.lm_params_from_numpy`
    carries a reference tree across instead)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _init_tree(cfg, gen)


def _init_tree(cfg: LMConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg.param_dtype)
    n_loc, n_glob = _n_local_global(cfg)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=1.0),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    if n_loc:
        params["local_layers"] = _stack_init(cfg, gen, n_loc)
        params["global_layers"] = _stack_init(cfg, gen, n_glob)
    else:
        params["layers"] = _stack_init(cfg, gen, cfg.n_layers)
    return params


def unbind_layers(stack: dict) -> list:
    """Every layer of a stacked tree, taken by one ``unbind`` per leaf:
    its backward stacks the layers' gradients once, where indexing
    ``v[i]`` would add a full ``[L, ...]`` gradient per layer."""
    parts = {k: unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in stack.items()}
    n = len(next(iter(parts.values())))
    return [{k: parts[k][i] for k in stack} for i in range(n)]


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def cast_layer(layer: dict, dtype: torch.dtype) -> dict:
    """One layer of ``unbind_layers``, every leaf cast to ``dtype`` (the
    MoE router too, as the reference's per-layer cast does)."""
    return {k: cast_layer(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in layer.items()}


def _unbind_stacks(params, sched) -> dict:
    """Each stack the schedule names, by ``unbind_layers``."""
    return {name: unbind_layers(params[name])
            for name in dict.fromkeys(st for st, _, _ in sched)}


def _schedule(cfg: LMConfig):
    """The layers in order as (stack name, index in it, is_local)."""
    n_loc, n_glob = _n_local_global(cfg)
    if not n_loc:
        return [("layers", i, False) for i in range(cfg.n_layers)]
    r = cfg.local_global_ratio
    out = []
    for g in range(n_glob):
        out += [("local_layers", g * r + j, True) for j in range(r)]
        out.append(("global_layers", g, False))
    return out


def _head(params, cfg: LMConfig, x):
    x = L.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (q-chunked, window as a value)
# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, *, window: int, q_chunk: int,
                      q_offset: int = 0):
    """Causal GQA attention, one q chunk at a time.

    q: [B, S, Hq, D]; k, v: [B, T, Hkv, D]; ``window`` <= 0 means full.
    Query i (absolute position ``q_offset + i``) attends to key j when
    ``j <= pos`` and ``j > pos - window``.  Each chunk's logits cover the
    whole T (local layers too) in fp32 with -1e30 where masked; the
    probabilities are cast to ``v``'s dtype before the value product."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    q_chunk = min(q_chunk, S)
    if S % q_chunk:
        raise ValueError(f"sequence {S} is not a multiple of q_chunk "
                         f"{q_chunk}")
    span = window if window > 0 else T + S
    kt = k.permute(0, 2, 3, 1).contiguous()          # [B, Hkv, D, T]
    vt = v.permute(0, 2, 1, 3).contiguous()          # [B, Hkv, T, D]
    k_pos = torch.arange(T, device=q.device)
    # under autograd nothing is written in place into a view: autograd
    # would copy the whole base for each such write in the backward
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    out = [] if grad else torch.empty_like(q)
    for c in range(S // q_chunk):
        s0 = c * q_chunk
        # [B, qc, Hkv, G, D] -> [B, Hkv, G * qc, D]
        q_c = q[:, s0:s0 + q_chunk].reshape(B, q_chunk, Hkv, G, D)
        q_c = q_c.permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * q_chunk, D)
        logits = (q_c @ kt) * scale                   # [B, Hkv, G*qc, T]
        logits = logits.float().view(B, Hkv, G, q_chunk, T)
        q_pos = q_offset + s0 + torch.arange(q_chunk, device=q.device)
        m = (k_pos[None, :] <= q_pos[:, None]) & \
            (k_pos[None, :] > q_pos[:, None] - span)
        if grad:          # one kernel each way (masked_fill would clone)
            logits = torch.where(m, logits, -1e30)
        else:
            logits.masked_fill_(~m, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = probs.view(B, Hkv, G * q_chunk, T) @ vt   # [B, Hkv, G*qc, D]
        o = o.view(B, Hkv, G, q_chunk, D).permute(0, 3, 1, 2, 4).reshape(
            B, q_chunk, Hq, D)
        if grad:
            out.append(o)
        else:
            out[:, s0:s0 + q_chunk] = o
    return torch.cat(out, dim=1) if grad else out


# ---------------------------------------------------------------------------
# Transformer block
# ---------------------------------------------------------------------------
def _project_qkv(p, x, cfg: LMConfig, positions):
    B, S, _ = x.shape
    dh = cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, dh)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, dh)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, dh)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(p, h, cfg: LMConfig):
    if cfg.moe:
        ff, _ = M.moe_ffn(h, p["moe"], cfg)   # grouped dispatch: [B, S, d]
        return ff
    return L.swiglu(h, **p["mlp"])


def block_forward(p, x, cfg: LMConfig, *, window: int, positions,
                  q_chunk: int = 512, return_kv: bool = False,
                  kv_keep: int = 0):
    """One transformer block over a full sequence (forward / prefill).

    With ``return_kv`` the block also returns its (k, v), the prefill
    path; ``kv_keep`` > 0 keeps only the trailing ``kv_keep`` positions
    (a local layer's window)."""
    h = L.rms_norm(x, p["attn_norm"])
    q, k, v = _project_qkv(p, h, cfg, positions)
    attn = chunked_attention(q, k, v, window=window, q_chunk=q_chunk)
    x = x + (attn.reshape(*x.shape[:2], -1) @ p["wo"])
    h = L.rms_norm(x, p["mlp_norm"])
    x = x + _ffn(p, h, cfg)
    if not return_kv:
        return x
    if kv_keep:
        k, v = k[:, -kv_keep:], v[:, -kv_keep:]
    return x, (k, v)


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------
def _embed(params, tokens, cfg: LMConfig):
    cdt = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    # index_select, not ``[tokens]``: its gradient (``index_add_``) sums
    # in a fixed order on the CPU, and on CUDA under deterministic mode
    x = torch.index_select(params["embed"].to(cdt), 0,
                           tokens.reshape(-1).long()).reshape(B, S, -1)
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions, cdt


def lm_forward(params, tokens, cfg: LMConfig, q_chunk: int = 512):
    """Logits [B, S, vocab] in the compute dtype.  tokens: int [B, S]."""
    x, positions, cdt = _embed(params, tokens, cfg)
    win = cfg.sliding_window or 0
    sched = _schedule(cfg)
    layers = _unbind_stacks(params, sched)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(params))
    for stack, i, local in sched:
        kw = dict(cfg=cfg, window=win if local else 0, positions=positions,
                  q_chunk=q_chunk)
        p = cast_layer(layers[stack][i], cdt)
        if remat:
            x = checkpoint(block_forward, p, x, use_reentrant=False, **kw)
        else:
            x = block_forward(p, x, **kw)
    return _head(params, cfg, x)


def lm_loss(params, tokens, cfg: LMConfig, q_chunk: int = 512):
    """Next-token cross-entropy (fp32 log-softmax)."""
    logits = lm_forward(params, tokens, cfg, q_chunk=q_chunk)
    logits = logits[:, :-1].float()
    labels = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def lm_prefill(params, tokens, cfg: LMConfig, q_chunk: int = 512):
    """Prefill: the full forward that also fills a per-layer KV cache.

    Returns (last-position logits fp32 [B, V], DecodeCache with S
    entries a global layer; local layers keep the trailing
    ``W = min(sliding_window, S)``)."""
    x, positions, cdt = _embed(params, tokens, cfg)
    B, S = tokens.shape
    n_loc, n_glob = _n_local_global(cfg)
    shape = (B, S, cfg.n_kv_heads, cfg.d_head)
    kg = x.new_empty((n_glob if n_loc else cfg.n_layers,) + shape)
    vg = torch.empty_like(kg)
    kl = vl = None
    W = 0
    if n_loc:
        W = min(cfg.sliding_window, S)
        kl = x.new_empty((n_loc, B, W) + shape[2:])
        vl = torch.empty_like(kl)
    sched = _schedule(cfg)
    layers = _unbind_stacks(params, sched)
    for stack, i, local in sched:
        p = cast_layer(layers[stack][i], cdt)
        x, (k, v) = block_forward(
            p, x, cfg, window=cfg.sliding_window if local else 0,
            positions=positions, q_chunk=q_chunk, return_kv=True,
            kv_keep=W if local else 0)
        kc, vc = (kl, vl) if local else (kg, vg)
        kc[i], vc[i] = k, v
        del k, v
    logits = _head(params, cfg, x[:, -1]).float()
    return logits, DecodeCache(k=kg, v=vg, k_loc=kl, v_loc=vl)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------
class DecodeCache(NamedTuple):
    k: torch.Tensor          # [L, B, T, Hkv, D]  (global layers)
    v: torch.Tensor
    k_loc: Optional[torch.Tensor] = None   # local-layer ring buffers
    v_loc: Optional[torch.Tensor] = None
    # int8 cache (cfg.kv_quant): per-(token, kv-head) fp32 scales
    k_sc: Optional[torch.Tensor] = None       # [L, B, T, Hkv]
    v_sc: Optional[torch.Tensor] = None
    k_loc_sc: Optional[torch.Tensor] = None
    v_loc_sc: Optional[torch.Tensor] = None


def init_decode_cache(cfg: LMConfig, batch: int, max_len: int,
                      device="cuda") -> DecodeCache:
    """Zeros: ``max_len`` slots a global layer, ``min(sliding_window,
    max_len)`` ring slots a local layer; int8 with fp32 scales under
    ``kv_quant``."""
    dt = torch.int8 if cfg.kv_quant else dtype_of(cfg.compute_dtype)
    n_loc, n_glob = _n_local_global(cfg)
    dh, hkv = cfg.d_head, cfg.n_kv_heads

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    shape_g = (n_glob if n_loc else cfg.n_layers, batch, max_len, hkv, dh)
    f = {"k": zeros(shape_g, dt), "v": zeros(shape_g, dt)}
    if cfg.kv_quant:
        f["k_sc"] = zeros(shape_g[:-1], torch.float32)
        f["v_sc"] = zeros(shape_g[:-1], torch.float32)
    if n_loc:
        shape_l = (n_loc, batch, min(cfg.sliding_window, max_len), hkv, dh)
        f["k_loc"], f["v_loc"] = zeros(shape_l, dt), zeros(shape_l, dt)
        if cfg.kv_quant:
            f["k_loc_sc"] = zeros(shape_l[:-1], torch.float32)
            f["v_loc_sc"] = zeros(shape_l[:-1], torch.float32)
    return DecodeCache(**f)


def _decode_attn(q, k_cache, v_cache, pos: int, *, ring: bool,
                 window: int = 0, k_sc=None, v_sc=None):
    """q: [B, 1, Hq, D]; cache: [B, T, Hkv, D]; pos: the position being
    decoded.  Softmax in fp32.  An int8 cache's scales fold into the two
    dots as in the reference: the logits times ``k_sc`` after the q.k
    dot, the probabilities times ``v_sc`` before the value dot (both in
    fp32); unquantised, the probabilities are cast to the cache's dtype
    first.  A ring cache's slot j holds position ``pos - ((pos - j) mod
    T)``, valid when that is >= 0."""
    B, _, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, Hkv, Hq // Hkv, D)
    cdt = qg.dtype if k_sc is None else torch.float32
    logits = torch.einsum("bskgd,btkd->bkgst", qg.to(cdt),
                          k_cache.to(cdt)) * (D ** -0.5)
    logits = logits.float()
    if k_sc is not None:
        logits = logits * k_sc.permute(0, 2, 1)[:, :, None, None, :]
    slot = torch.arange(T, device=q.device)
    if ring:
        valid = pos - torch.remainder(pos - slot, T) >= 0
    else:
        valid = slot <= pos
        if window:
            valid &= slot > pos - window
    logits = torch.where(valid, logits, torch.tensor(-1e30,
                                                     device=q.device))
    probs = torch.softmax(logits, dim=-1)
    if v_sc is not None:
        probs = probs * v_sc.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache.float())
    else:
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(v_cache.dtype),
                           v_cache)
    return out.reshape(B, 1, Hq, D)


def _quant_kv(x):
    """[B, 1, Hkv, D] -> (int8 values, [B, 1, Hkv] fp32 scale); rounds
    half to even, as ``jnp.round`` does."""
    s = torch.amax(torch.abs(x.float()), dim=-1) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(x.float() / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _decode_block(p, x, kv, pos: int, cfg: LMConfig, *, ring: bool):
    """One layer of one decode step; writes this token's k/v (and its
    scales) into the layer's cache views ``kv`` in place: a ring at
    ``pos % T``, elsewhere at ``pos`` clamped to the last slot (as
    ``dynamic_update_slice`` clamps)."""
    k_cache, v_cache, k_sc, v_sc = kv
    B = x.shape[0]
    h = L.rms_norm(x, p["attn_norm"])
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, h, cfg, positions)
    T = k_cache.shape[1]
    write = pos % T if ring else min(pos, T - 1)
    if cfg.kv_quant:
        k, ks = _quant_kv(k)
        v, vs = _quant_kv(v)
        k_sc[:, write] = ks[:, 0]
        v_sc[:, write] = vs[:, 0]
    k_cache[:, write] = k[:, 0]
    v_cache[:, write] = v[:, 0]
    attn = _decode_attn(q, k_cache, v_cache, pos, ring=ring, k_sc=k_sc,
                        v_sc=v_sc)
    x = x + (attn.reshape(B, 1, -1) @ p["wo"])
    h = L.rms_norm(x, p["mlp_norm"])
    return x + _ffn(p, h, cfg)


def lm_decode_step(params, cache: DecodeCache, token, pos: int,
                   cfg: LMConfig):
    """One decode step.  token: int[B, 1]; pos: int (current length).
    Returns (logits fp32 [B, vocab], cache); the cache is updated in
    place and returned for the reference's calling convention."""
    cdt = dtype_of(cfg.compute_dtype)
    pos = int(pos)
    x = params["embed"].to(cdt)[token.long()]
    sched = _schedule(cfg)
    layers = _unbind_stacks(params, sched)
    for stack, i, local in sched:
        p = cast_layer(layers[stack][i], cdt)
        names = ("k_loc", "v_loc", "k_loc_sc", "v_loc_sc") if local else \
            ("k", "v", "k_sc", "v_sc")
        kv = tuple(None if getattr(cache, n) is None else getattr(cache, n)[i]
                   for n in names)
        x = _decode_block(p, x, kv, pos, cfg, ring=local)
    logits = _head(params, cfg, x[:, 0]).float()
    return logits, cache
