"""Decoder-only transformer LM, the dense part: initialisation and the
decode-with-KV-cache step (the reference's ``models/transformer.py``).

Parameters are a plain dict with the reference's tree names; the layer
stack ``params["layers"]`` holds ``[L, ...]`` tensors, one leading slice
per layer.  The dense decode (:func:`lm_decode_step`) is the oracle the
paged decode of :mod:`repro_torch.paged.serve_model` is held against.

Not ported yet (ROADMAP.md Queue 1 item 12): MoE layers, local/global
(sliding-window) stacks, the int8 KV cache, and the train/prefill
forward passes.  A config asking for one raises ``NotImplementedError``.
There is one device, so the reference's sharding constraints are gone;
the dense cache is updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L


def dtype_of(name: str) -> torch.dtype:
    """torch dtype of a config's dtype name (``"float32"``, ...)."""
    return getattr(torch, name)


def require_dense(cfg: LMConfig) -> None:
    """Raise for the config features the port does not run yet."""
    for flag in ("moe", "local_global_ratio", "kv_quant"):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{cfg.name}: {flag} is not ported yet (ROADMAP.md Queue 1 "
                f"item 12); the port runs dense, all-global, unquantised "
                f"decoders")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _stack_init(cfg: LMConfig, gen: torch.Generator, n: int) -> dict:
    """``n`` layers' parameters, stacked ``[n, ...]`` (drawn at once where
    the reference vmaps its per-layer ``_init_layer``)."""
    dt = dtype_of(cfg.param_dtype)
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def w(*shape):
        return L.dense_init(gen, (n,) + shape, dt)
    return {
        "attn_norm": torch.zeros((n, d), dtype=dt, device=gen.device),
        "mlp_norm": torch.zeros((n, d), dtype=dt, device=gen.device),
        "wq": w(d, hq * dh),
        "wk": w(d, hkv * dh),
        "wv": w(d, hkv * dh),
        "wo": w(hq * dh, d),
        "mlp": {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)},
    }


def init_lm(cfg: LMConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the shapes, dtypes and scales of the
    reference's ``init_lm`` (its ``jax.random`` stream cannot be
    reproduced; :func:`repro_torch.core.convert.lm_params_from_numpy`
    carries a reference tree across instead)."""
    require_dense(cfg)
    dt = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=1.0),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    params["layers"] = _stack_init(cfg, gen, cfg.n_layers)
    return params


def layer_params(stack: dict, i: int, dtype: torch.dtype) -> dict:
    """Layer ``i`` of a stacked tree, cast to ``dtype``."""
    return {k: layer_params(v, i, dtype) if isinstance(v, dict)
            else v[i].to(dtype) for k, v in stack.items()}


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


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------
class DecodeCache(NamedTuple):
    k: torch.Tensor          # [L, B, T, Hkv, D]
    v: torch.Tensor


def init_decode_cache(cfg: LMConfig, batch: int, max_len: int,
                      device="cuda") -> DecodeCache:
    require_dense(cfg)
    dt = dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return DecodeCache(k=torch.zeros(shape, dtype=dt, device=device),
                       v=torch.zeros(shape, dtype=dt, device=device))


def _decode_attn(q, k_cache, v_cache, pos):
    """q: [B, 1, Hq, D]; cache: [B, T, Hkv, D]; pos: int (the position
    being decoded).  Softmax in fp32; the probabilities are cast to the
    cache's dtype before the value product, as in the reference."""
    B, _, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k_cache) * (D ** -0.5)
    logits = logits.float()
    valid = torch.arange(T, device=q.device) <= pos
    logits = torch.where(valid, logits, torch.tensor(-1e30,
                                                     device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return out.reshape(B, 1, Hq, D)


def _decode_block(p, x, kv, pos: int, cfg: LMConfig):
    """One layer of one decode step; writes this token's k/v into the
    layer's cache views ``kv`` in place."""
    k_cache, v_cache = kv
    B = x.shape[0]
    h = L.rms_norm(x, p["attn_norm"])
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, h, cfg, positions)
    write = min(pos, k_cache.shape[1] - 1)   # dynamic_update_slice clamps
    k_cache[:, write] = k[:, 0]
    v_cache[:, write] = v[:, 0]
    attn = _decode_attn(q, k_cache, v_cache, pos)
    x = x + (attn.reshape(B, 1, -1) @ p["wo"])
    h = L.rms_norm(x, p["mlp_norm"])
    return x + L.swiglu(h, **p["mlp"])


def lm_decode_step(params, cache: DecodeCache, token, pos: int,
                   cfg: LMConfig):
    """One decode step.  token: int[B, 1]; pos: int (current length).
    Returns (logits fp32 [B, vocab], cache) — the cache is updated in
    place and returned for the reference's calling convention."""
    require_dense(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    pos = int(pos)
    x = params["embed"].to(cdt)[token]
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i, cdt)
        x = _decode_block(p, x, (cache.k[i], cache.v[i]), pos, cfg)
    x = L.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x[:, 0] @ head.to(cdt)).float()
    return logits, cache
