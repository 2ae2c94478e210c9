"""Paged KV cache: the paper's slice-pool allocator applied to LM serving
(the reference's ``paged/kv_cache.py``), in torch.

A decoding sequence's KV history is allocated in increasingly larger
slices from fixed pools with packed-pointer chaining — ``Z_kv = <6, 8,
10>`` by default (64/256/1024-token slices).  A "slot" holds one token's
K/V vectors for all layers and KV heads, so slice links live in a
sidecar array indexed by flat slice id; slices hold a full ``2**z``
tokens.  Appends are batched (every active sequence appends one token
per decode step; pool contention resolves with a prefix-sum rank), and
every slice size is a multiple of ``PAGE`` (64 tokens), so a flattened
chain is a page table of uniform tiles — what the ``paged_attention``
kernel walks.

Port conventions: ``link`` and ``tail`` hold uint32 pointers (NULL =
0xFFFFFFFF) as int64; the state is mutated in place, so no caller may
keep an alias of an old state.  The reference's ``mode="drop"`` scatters
become masked writes (torch raises on out-of-range indices).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import pointers as ptr_mod
from repro_torch.core.pointers import NULL, PoolLayout

PAGE = 64  # tokens per kernel-visible page


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    layout: PoolLayout            # z in log2 TOKENS per slice
    n_layers: int
    n_kv_heads: int
    d_head: int
    max_seqs: int
    dtype: str = "float32"

    def __post_init__(self):
        assert min(self.layout.z) >= int(math.log2(PAGE)), (
            f"KV slices must be >= one {PAGE}-token page")

    @property
    def total_slice_count(self) -> int:
        return sum(self.layout.slices_per_pool)


def default_kv_layout(slices_per_pool=(512, 256, 128)) -> PoolLayout:
    """Z_kv = <6, 8, 10>: 64 / 256 / 1024-token slices."""
    return PoolLayout(z=(6, 8, 10), slices_per_pool=tuple(slices_per_pool))


class PagedKVState(NamedTuple):
    k_heap: torch.Tensor     # [L, Hkv, slots, D]
    v_heap: torch.Tensor     # [L, Hkv, slots, D]
    link: torch.Tensor       # int64[total_slices] previous-slice pointer
    watermark: torch.Tensor  # int32[P]
    tail: torch.Tensor       # int64[max_seqs] packed ptr to last slot
    length: torch.Tensor     # int32[max_seqs]
    overflow: torch.Tensor   # bool[]


def _slice_id_base(layout: PoolLayout) -> np.ndarray:
    base, acc = [], 0
    for n in layout.slices_per_pool:
        base.append(acc)
        acc += n
    return np.asarray(base, np.int64)


def init_kv_state(cfg: PagedKVConfig, device="cuda") -> PagedKVState:
    lay = cfg.layout
    dev = torch.device(device)
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, cfg.n_kv_heads, lay.total_slots, cfg.d_head)
    return PagedKVState(
        k_heap=torch.zeros(shape, dtype=dt, device=dev),
        v_heap=torch.zeros(shape, dtype=dt, device=dev),
        link=torch.full((cfg.total_slice_count,), NULL, dtype=torch.int64,
                        device=dev),
        watermark=torch.zeros((lay.num_pools,), dtype=torch.int32,
                              device=dev),
        tail=torch.full((cfg.max_seqs,), NULL, dtype=torch.int64,
                        device=dev),
        length=torch.zeros((cfg.max_seqs,), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def kv_slots_allocated(cfg: PagedKVConfig, state: PagedKVState) -> int:
    wm = state.watermark.cpu().numpy().astype(np.int64)
    return int(np.sum(wm * np.asarray(cfg.layout.slice_sizes, np.int64)))


def _as_int32(addr):
    """The reference's ``uint32.astype(int32)``: values >= 2**31 wrap
    negative (int64 tensors holding the result)."""
    return torch.where(addr >= 1 << 31, addr - (1 << 32), addr)


def make_append_fn(cfg: PagedKVConfig, device="cuda"):
    """Batched one-token-per-sequence append (one decode step).

    append(state, seq_ids [B], k [L, B, Hkv, D], v) -> state, mutated in
    place.  Distinct seq_ids required (each active sequence appends
    once).  A sequence whose pool is exhausted sets the sticky
    ``overflow`` flag and keeps its tail and length."""
    lay = cfg.layout
    dev = torch.device(device)
    tbl = lay.tables(dev)
    pb = lay.pool_bits
    P = lay.num_pools
    caps = torch.as_tensor(lay.slices_per_pool, dtype=torch.int64,
                           device=dev)
    sid_base = torch.as_tensor(_slice_id_base(lay), device=dev)
    pools = torch.arange(P, device=dev)

    def append(state: PagedKVState, seq_ids, k, v) -> PagedKVState:
        t = state.tail[seq_ids]
        new = ptr_mod.is_null(t)
        pool, sl, off = ptr_mod.decode(tbl, pb, t)
        cap = tbl["slice_size"][pool]
        full = (~new) & (off == cap - 1)
        need = new | full
        alloc_pool = torch.where(new, 0, torch.clamp(pool + 1, max=P - 1))

        # prefix-sum rank assignment per pool
        onehot = (alloc_pool[:, None] == pools) & need[:, None]
        rank = torch.cumsum(onehot.long(), dim=0) - 1          # [B, P]
        rank_b = torch.gather(rank, 1, alloc_pool[:, None])[:, 0]
        slice_new = state.watermark.long()[alloc_pool] + rank_b
        ok = ~need | (slice_new < caps[alloc_pool])
        state.watermark.add_(onehot.sum(0).int())
        state.overflow.logical_or_(torch.any(~ok))

        # link sidecar: a new slice points at the old tail (NULL for a
        # new sequence); the reference drops the other lanes
        lk = torch.nonzero(need & ok)[:, 0]
        flat_new = sid_base[alloc_pool] + slice_new
        state.link[flat_new[lk]] = torch.where(new, NULL, t)[lk]

        # write position
        w_pool = torch.where(need, alloc_pool, pool)
        w_slice = torch.where(need, slice_new, sl)
        w_off = torch.where(need, 0, off + 1)
        addr = _as_int32(ptr_mod.to_addr(tbl, w_pool, w_slice, w_off))
        # k, v: [L, B, Hkv, D] -> the slot axis of [L, Hkv, slots, D]
        okl = torch.nonzero(ok)[:, 0]
        for heap, x in ((state.k_heap, k), (state.v_heap, v)):
            heap.index_copy_(2, addr[okl], x.index_select(1, okl)
                             .permute(0, 2, 1, 3).to(heap.dtype))

        new_tail = ptr_mod.encode(tbl, pb, w_pool, w_slice, w_off)
        state.tail[seq_ids] = torch.where(ok, new_tail, t)
        state.length.index_add_(0, seq_ids, ok.int())
        return state

    return append


def make_page_table_fn(cfg: PagedKVConfig, max_pages: int, device="cuda"):
    """Build ``tables(state, seq_ids) -> int32[B, max_pages]`` of page ids
    (page = PAGE-token tile; page id = slot_addr // PAGE), chronological
    order, padded with -1.  The chain walk is one loop of up to
    ``max_pages`` steps over all B sequences at once, which stops when
    every chain has ended (one host sync per step); a chain longer than
    that keeps its newest ``max_pages`` slices, as in the reference."""
    lay = cfg.layout
    dev = torch.device(device)
    tbl = lay.tables(dev)
    pb = lay.pool_bits
    sid_base = torch.as_tensor(_slice_id_base(lay), device=dev)
    pages_per_slice = torch.as_tensor(
        [s // PAGE for s in lay.slice_sizes], dtype=torch.int64, device=dev)
    max_slices = max_pages  # a slice is >= 1 page
    n_link = cfg.total_slice_count

    def tables(state: PagedKVState, seq_ids):
        B = seq_ids.shape[0]
        ptr = state.tail[seq_ids]
        bases = torch.full((B, max_slices), -1, dtype=torch.int64,
                           device=dev)
        npages = torch.zeros((B, max_slices), dtype=torch.int64, device=dev)
        n = torch.zeros((B,), dtype=torch.int64, device=dev)
        for i in range(max_slices):
            live = ~ptr_mod.is_null(ptr)
            if not bool(live.any()):
                break          # every chain has ended: the rest is a no-op
            pool, sl, _ = ptr_mod.decode(tbl, pb, ptr)
            base = _as_int32(ptr_mod.to_addr(tbl, pool, sl,
                                              torch.zeros_like(sl)))
            bases[:, i] = torch.where(live, base, -1)
            npages[:, i] = torch.where(live, pages_per_slice[pool], 0)
            flat = (sid_base[pool] + sl).clamp(0, n_link - 1)  # JAX clamps
            ptr = torch.where(live, state.link[flat], ptr)
            n += live
        # newest-first -> chronological
        idx = n[:, None] - 1 - torch.arange(max_slices, device=dev)
        src = idx.clamp(min=0)
        bases = torch.where(idx >= 0, torch.gather(bases, 1, src), -1)
        npages = torch.where(idx >= 0, torch.gather(npages, 1, src), 0)
        # expand slices to pages
        cum = torch.cumsum(npages, dim=1)
        start = cum - npages
        j = torch.arange(max_pages, device=dev).expand(B, max_pages)
        s = torch.searchsorted(cum, j.contiguous(), right=True)
        s = s.clamp(max=max_slices - 1)
        within = j - torch.gather(start, 1, s)
        b_s = torch.gather(bases, 1, s)
        page = torch.where(b_s >= 0, torch.div(b_s, PAGE,
                                               rounding_mode="floor")
                           + within, -1)
        # trim to actually-used pages (length-derived)
        n_used = -(-state.length[seq_ids].long() // PAGE)
        return torch.where(j < n_used[:, None], page, -1).int()

    return tables


def gather_kv(state: PagedKVState, page_table, layer: int):
    """Reference KV gather: [B, max_pages*PAGE, Hkv, D] (padded zeros)."""
    B, n_pages = page_table.shape
    pt = page_table.long()
    slots = pt[:, :, None] * PAGE + torch.arange(PAGE, device=pt.device)
    slots = torch.where(pt[:, :, None] >= 0, slots, -1)
    flat = slots.reshape(B, n_pages * PAGE)                # [B, T]
    # heap[layer]: [Hkv, slots, D]; gather -> [Hkv, B, T, D]
    k = state.k_heap[layer][:, flat.clamp(min=0)]
    v = state.v_heap[layer][:, flat.clamp(min=0)]
    valid = (flat >= 0)[None, :, :, None]
    k = torch.where(valid, k, 0).permute(1, 2, 0, 3)
    v = torch.where(valid, v, 0).permute(1, 2, 0, 3)
    return k, v


# ---------------------------------------------------------------------------
# Analytical model transfer (paper §5 -> KV serving)
# ---------------------------------------------------------------------------
def kv_memory_slots(z: Tuple[int, ...], length) -> np.ndarray:
    """Token slots allocated for a sequence of given length (no pointer
    slots — links are sidecar).  Counterpart of analytical.memory_slots."""
    length = np.asarray(length, np.int64)
    sizes = np.asarray([1 << zz for zz in z], np.int64)
    fmax = int(length.max()) if length.size else 1
    # thresholds: cumulative capacity (full slices, no pointer slot)
    th = [sizes[0]]
    while th[-1] < fmax:
        nxt = sizes[min(len(th), len(z) - 1)]
        th.append(th[-1] + nxt)
    th = np.asarray(th, np.int64)
    i = np.searchsorted(th, np.maximum(length, 1), side="left")
    return th[i]


def kv_pages_touched(z: Tuple[int, ...], length) -> np.ndarray:
    """Pages read per decode attention step (the paper's C_T analogue)."""
    return -(-np.asarray(length, np.int64) // PAGE)


def make_tail_addr_fn(cfg: PagedKVConfig, device="cuda"):
    """tail_addrs(state, seq_ids) -> int[B] heap slot address of each
    sequence's most recently written token (for per-layer staged writes
    in the serving loop), with the reference's int32 wrap."""
    tbl = cfg.layout.tables(torch.device(device))
    pb = cfg.layout.pool_bits

    def tail_addrs(state: PagedKVState, seq_ids):
        t = state.tail[seq_ids]
        return _as_int32(ptr_mod.ptr_to_addr(tbl, pb, t))

    return tail_addrs


def write_index(state: PagedKVState, addrs):
    """(lanes, slots) of a staged write: the lanes of ``addrs`` the
    reference's scatter keeps, and their slot ids.  Like the reference,
    a negative address counts from the end and one still out of range
    is dropped (only an overflowed new sequence's NULL tail gives one).
    One host sync; the serving loop computes it once per decode step
    for all layers."""
    slots = state.k_heap.shape[2]
    a = torch.where(addrs < 0, addrs + slots, addrs)
    lanes = torch.nonzero((a >= 0) & (a < slots))[:, 0]
    return lanes, a[lanes]


def write_layer_kv(state: PagedKVState, layer: int, addrs, k, v,
                   index=None) -> PagedKVState:
    """Write one token's k/v for ONE layer at pre-allocated heap slots,
    in place.

    addrs: int[B]; k, v: [B, Hkv, D]; ``index``: :func:`write_index` of
    ``addrs`` when the caller has it.  Used by the staged decode loop:
    ``append`` first reserves the slot for all layers (zero fill), then
    each layer writes its k/v as it is computed.  The reference writes
    ``heap.at[layer, :, addrs, :]``, whose numpy-rule shape is [B, Hkv,
    D]; torch would index that as [Hkv, B, D] and, when B == Hkv,
    silently transpose, so the write goes through the slot axis of
    ``heap[layer]`` explicitly.
    """
    lanes, a = write_index(state, addrs) if index is None else index
    for heap, x in ((state.k_heap, k), (state.v_heap, v)):
        heap[layer].index_copy_(
            1, a, x.index_select(0, lanes).permute(1, 0, 2).to(heap.dtype))
    return state
