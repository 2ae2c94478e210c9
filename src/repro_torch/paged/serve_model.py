"""Paged LM decode: the slice-pool allocator as the KV store of a real
decoder (the reference's ``paged/serve_model.py``).

Step protocol (staged writes):
  1. ``append`` reserves this token's slot for ALL layers (zero fill) and
     updates tail/length — one allocator transaction per decode step,
     exactly the paper's ingest path with sequences as "terms".
  2. page tables are flattened once per step (chain -> pages).
  3. each layer computes q/k/v, writes its k/v into the reserved slot
     (``write_layer_kv``) and attends over the page table with the
     ``paged_attention`` kernel (its plain version on the CPU).

Runs dense, all-global LMConfigs (GQA supported), as the reference's
demo server does: ``make_server`` refuses MoE and local/global configs.
The heaps hold the compute dtype whatever ``kv_quant`` says (the
reference's paged server ignores it too).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.paged import kv_cache as P


class PagedServer(NamedTuple):
    cfg: LMConfig
    kv_cfg: P.PagedKVConfig
    append: Callable
    tables: Callable
    tail_addrs: Callable
    max_pages: int
    device: torch.device


def make_server(cfg: LMConfig, layout, max_seqs: int, max_len: int,
                device="cuda") -> PagedServer:
    if cfg.moe or cfg.local_global_ratio:
        raise ValueError(f"{cfg.name}: the paged server runs dense, "
                         f"all-global LMs (no MoE, no local/global stacks)")
    dev = torch.device(device)
    kv_cfg = P.PagedKVConfig(layout=layout, n_layers=cfg.n_layers,
                             n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                             max_seqs=max_seqs, dtype=cfg.compute_dtype)
    max_pages = -(-max_len // P.PAGE)
    return PagedServer(
        cfg=cfg, kv_cfg=kv_cfg,
        append=P.make_append_fn(kv_cfg, dev),
        tables=P.make_page_table_fn(kv_cfg, max_pages, dev),
        tail_addrs=P.make_tail_addr_fn(kv_cfg, dev),
        max_pages=max_pages, device=dev)


def _layer_qkv(p, x, cfg: LMConfig, positions):
    h = L.rms_norm(x, p["attn_norm"])
    q, k, v = T._project_qkv(p, h, cfg, positions)
    return q, k, v


def decode_step(server: PagedServer, params, state: P.PagedKVState,
                seq_ids, tokens):
    """One token for every active sequence.

    seq_ids: int[B] distinct slots; tokens: int[B] (tensors on the
    server's device).  Returns (next_tokens int32[B], logits fp32 [B, V],
    state) — the state is updated in place.
    """
    cfg = server.cfg
    cdt = T.dtype_of(cfg.compute_dtype)
    B = seq_ids.shape[0]
    seq_ids = seq_ids.long()

    # 1. reserve slots (zero k/v), lengths += 1
    zeros = torch.zeros((cfg.n_layers, B, cfg.n_kv_heads, cfg.d_head),
                        dtype=cdt, device=server.device)
    state = server.append(state, seq_ids, zeros, zeros)
    addrs = server.tail_addrs(state, seq_ids)
    index = P.write_index(state, addrs)     # one sync for all layers
    table = server.tables(state, seq_ids)
    lengths = state.length[seq_ids]
    positions = (lengths.long() - 1)[:, None]              # [B, 1]

    x = params["embed"].to(cdt)[tokens.long()[:, None]]   # [B, 1, d]
    G = cfg.n_heads // cfg.n_kv_heads
    for i in range(cfg.n_layers):
        p = T.layer_params(params["layers"], i, cdt)
        q, k, v = _layer_qkv(p, x, cfg, positions)
        P.write_layer_kv(state, i, addrs, k[:, 0], v[:, 0], index=index)
        qh = q.reshape(B, cfg.n_kv_heads, G, cfg.d_head)
        attn = ops.paged_attention(qh, state.k_heap[i], state.v_heap[i],
                                   table, lengths)          # [B,Hkv,G,D]
        attn = attn.to(cdt).reshape(B, 1, -1)
        x = x + attn @ p["wo"]
        h = L.rms_norm(x, p["mlp_norm"])
        x = x + L.swiglu(h, **p["mlp"])

    x = L.rms_norm(x[:, 0], params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(cdt)).float()
    return torch.argmax(logits, -1).int(), logits, state


def prefill(server: PagedServer, params, state, seq_ids, prompt,
            prompt_len):
    """Token-by-token prefill through the decode path.

    seq_ids: int[B]; prompt: int[B, Lmax] padded; prompt_len: int[B]
    (host arrays).  Host-side filtering keeps each decode_step batch
    dense — only still-prefilling sequences append (allocator lengths
    stay exact).  Returns (first generated token per seq, int32[B] on the
    host, state)."""
    prompt = np.asarray(prompt)
    prompt_len = np.asarray(prompt_len)
    seq_ids = np.asarray(seq_ids)
    nxt = np.zeros(len(seq_ids), np.int32)
    for t in range(int(prompt_len.max())):
        sel = np.nonzero(prompt_len > t)[0]
        ids = torch.as_tensor(seq_ids[sel], dtype=torch.int64,
                              device=server.device)
        toks = torch.as_tensor(prompt[sel, t], dtype=torch.int64,
                               device=server.device)
        nxt_t, _, state = decode_step(server, params, state, ids, toks)
        done = prompt_len[sel] == t + 1
        nxt[sel[done]] = nxt_t.cpu().numpy()[done]
    return nxt, state
