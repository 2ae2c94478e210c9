"""Decode attention through a page table, on CUDA.

The paged-KV server (``paged/serve_model.py``) flattens each sequence's
slice chain into a table of 64-token pages; one launch of the kernel
(``csrc/paged_attention.cu``) walks those pages for every (sequence, KV
head) with an fp32 online softmax, each row split across ``S`` CTAs of
``pps`` pages (:func:`split_plan`) whose partials the last of them
merges in split order.  Layout:

  q          [B, Hkv, G, D]     (G = query heads per KV head)
  k/v heaps  [Hkv, slots, D]    (slot = token; pages are contiguous)
  page_table int32[B, NP]       (page ids, -1 padding)
  lengths    int32[B]
  out        [B, Hkv, G, D] fp32

q and the heaps may each be fp32 or bf16 (the heaps alike).  The plain
torch version is ``kernels.ref.paged_attention_ref``;
``kernels.ops.paged_attention`` routes by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

PAGE = 64
HEADS = 8             # query heads per CTA (the tensor-core tile's n)
CTAS_PER_SM = 4       # the grid the split rule aims at
MAX_SPLITS = 64       # the kernel's merge stages S x 8 weights
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_counters = {}        # (device index, stream) -> int32 zeros, one per unit


def split_plan(B: int, Hkv: int, G: int, NP: int, sms: int):
    """``(S, pps)``: split each row's ``NP`` pages into ``S`` runs of
    ``pps`` consecutive pages, so that the grid of ``B * Hkv *
    ceil(G / 8)`` units x ``S`` holds about ``CTAS_PER_SM`` CTAs per SM
    (at least half that, unless the table has too few pages or
    ``MAX_SPLITS`` caps it).  Shapes only: the lengths would cost a host
    sync."""
    units = B * Hkv * -(-G // HEADS)
    S = max(1, min(NP, MAX_SPLITS, (CTAS_PER_SM * sms) // units))
    pps = -(-NP // S)
    return -(-NP // pps), pps


def _index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _zeroed_counters(device, stream: int, n: int):
    """The kernel's per-unit tickets: zeroed once per (device, stream)
    (and when they grow); every launch leaves them zero.  Launches on
    one stream run in order, so they may share tickets; launches on two
    streams may overlap, so each stream has its own."""
    key = (_index(device), stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=device)
    return c


def paged_attention(q, k_heap, v_heap, page_table, lengths):
    """One launch of the CUDA kernel over ``PAGE``-token pages; see the
    module docstring."""
    name = "paged_attention"
    _cuda.require_cuda(name, q, k_heap, v_heap, page_table, lengths)
    if q.dim() != 4 or k_heap.dim() != 3 or v_heap.shape != k_heap.shape:
        raise ValueError(f"{name}: q must be [B, Hkv, G, D] and the heaps "
                         f"one shape [Hkv, slots, D]")
    B, Hkv, G, D = q.shape
    slots = k_heap.shape[1]
    if k_heap.shape[0] != Hkv or k_heap.shape[2] != D:
        raise ValueError(f"{name}: heaps {tuple(k_heap.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if not 8 <= D <= 256 or D % 8 or slots < PAGE:
        raise ValueError(f"{name}: needs D a multiple of 8 in [8, 256] and "
                         f"a heap of at least one page")
    if k_heap.data_ptr() % 16 or v_heap.data_ptr() % 16:
        raise ValueError(f"{name}: the heaps must be 16-byte aligned (the "
                         f"kernel reads pages in 16-byte chunks)")
    if q.dtype not in _BF16 or k_heap.dtype not in _BF16 or \
            v_heap.dtype != k_heap.dtype:
        raise TypeError(f"{name}: q and the heaps must be float32 or "
                        f"bfloat16 (one dtype for both heaps)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32 or \
            page_table.dim() != 2 or page_table.shape[0] != B or \
            lengths.shape != (B,):
        raise TypeError(f"{name}: page_table must be int32[{B}, NP] and "
                        f"lengths int32[{B}]")
    NP = page_table.shape[1]
    out = torch.empty((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    if B * Hkv * G == 0:
        return out
    if NP == 0:
        return out.zero_()
    S, pps = split_plan(B, Hkv, G, NP, _cuda.sm_count(q.device))
    units = B * Hkv * -(-G // HEADS)
    stream = _cuda.stream_ptr(q.device)
    ws = counters = None
    if S > 1:
        ws = torch.empty(units * S * (2 * HEADS + HEADS * D),
                         dtype=torch.float32, device=q.device)
        counters = _zeroed_counters(q.device, stream, units)
    paged_attention.launches += 1
    err = _cuda.lib().paged_attention_launch(
        q.data_ptr(), _BF16[q.dtype], k_heap.data_ptr(), v_heap.data_ptr(),
        _BF16[k_heap.dtype], page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        B, Hkv, G, D, NP, slots, S, pps, stream)
    _cuda.check(err, name)
    return out


paged_attention.launches = 0
