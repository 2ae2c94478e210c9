"""Plain torch versions of the port's CUDA kernels.

Each mirrors its reference oracle in the JAX package's
``kernels/ref.py``.  The CPU path runs them (``kernels.ops`` routes a CPU
tensor here), and the chip check holds every kernel against them on the
card.  uint32 values travel as int64 holding the value.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import PAGE
from repro_torch.kernels.segment_intersect import (SEG_BLOCK,
                                                   decode_packed,
                                                   decode_scores,
                                                   decode_stacked)

INVALID = 0xFFFFFFFF


def intersect_mask_ref(a, b, invalid: int = INVALID):
    """Membership mask: 1 where a[..., i] (valid) appears in b[...]. Both
    ascending, padded with ``invalid`` at the end; equal leading dims."""
    pos = torch.searchsorted(b.contiguous(), a.contiguous())
    pos = pos.clamp_(max=b.shape[-1] - 1)
    hit = (torch.gather(b, -1, pos) == a) & (a != invalid)
    return hit.to(torch.int32)


def bulk_append_ref(heap, tail, freq, post_addr, post_val, ptr_addr,
                    ptr_val, term_idx, term_tail, term_freq):
    """The fused scatter-append as four plain scatters, in place.  Skip
    lanes carry out-of-range addresses, which torch's indexing would
    reject where the reference's ``mode="drop"`` scatter skips them, so
    they are dropped first.  Live addresses are unique by construction,
    so the order of the writes is immaterial."""
    for target, addr, val in ((heap, post_addr, post_val),
                              (heap, ptr_addr, ptr_val),
                              (tail, term_idx, term_tail),
                              (freq, term_idx, term_freq)):
        live = (addr >= 0) & (addr < target.shape[0])
        target[addr[live]] = val[live].to(target.dtype)
    return heap, tail, freq


def segment_intersect_mask_ref(a_packed, b_packed):
    """Decode both PackedLists with the all-blocks decoder, then plain
    membership."""
    a_ids = decode_packed(a_packed)
    if a_ids.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=a_ids.device)
    b_ids = decode_packed(b_packed, a_ids.device)
    if b_ids.shape[0] == 0:
        return torch.zeros(a_ids.shape, dtype=torch.int32,
                           device=a_ids.device)
    return intersect_mask_ref(a_ids, b_ids)


def segment_intersect_mask_batched_ref(a_stacked, b_stacked):
    """Batched all-blocks decode of both ``[N, ...]`` stacks, then
    row-wise membership."""
    a_ids = decode_stacked(a_stacked)           # [N, NBa * SEG_BLOCK]
    if a_ids.shape[-1] == 0 or a_ids.shape[0] == 0:
        return torch.zeros(a_ids.shape, dtype=torch.int32,
                           device=a_ids.device)
    b_ids = decode_stacked(b_stacked)
    if b_ids.shape[-1] == 0:
        return torch.zeros(a_ids.shape, dtype=torch.int32,
                           device=a_ids.device)
    return intersect_mask_ref(a_ids, b_ids)


def scored_intersect_batched_ref(a_scored, b_scored, rest, th):
    """Decode docids and impact planes of both ``[N, ...]`` scored
    stacks; membership by searchsorted (the first occurrence is the real
    lane — lanes past b's count are INVALID); the two impacts summed
    where b's is positive; every a-block whose WAND bound ``a.bmax +
    rest`` cannot beat ``th`` zeroed."""
    a_ids = decode_stacked(a_scored.ids)        # [N, NBa * SEG_BLOCK]
    zeros = torch.zeros(a_ids.shape, dtype=torch.int32, device=a_ids.device)
    if a_ids.shape[-1] == 0 or a_ids.shape[0] == 0:
        return zeros
    b_ids = decode_stacked(b_scored.ids)
    if b_ids.shape[-1] == 0:
        return zeros
    a_sc = decode_scores(a_scored.swords)
    b_sc = decode_scores(b_scored.swords)
    pos = torch.searchsorted(b_ids, a_ids).clamp_(max=b_ids.shape[-1] - 1)
    hit = (torch.gather(b_ids, -1, pos) == a_ids) & (a_ids != INVALID)
    bs = torch.where(hit, torch.gather(b_sc, -1, pos), 0)
    bound = a_scored.bmax.to(torch.int32) + rest.to(torch.int32)[:, None]
    keep = torch.repeat_interleave(bound > th.to(torch.int32)[:, None],
                                   SEG_BLOCK, dim=-1)
    return torch.where(hit & keep & (bs > 0), a_sc + bs, zeros)


def paged_attention_ref(q, k_heap, v_heap, page_table, lengths):
    """Decode attention through a page table.

    q: [B, Hkv, G, D]; k_heap/v_heap: [Hkv, slots, D];
    page_table: int32[B, NP] ids of PAGE-token pages (-1 pad);
    lengths: int32[B].  Returns [B, Hkv, G, D] fp32.
    """
    page = PAGE
    B, Hkv, G, D = q.shape
    NP = page_table.shape[1]
    slots = (page_table.long().clamp(min=0)[:, :, None] * page
             + torch.arange(page, device=q.device)).reshape(B, NP * page)
    k = k_heap[:, slots].permute(1, 0, 2, 3).float()   # [B, Hkv, T, D]
    v = v_heap[:, slots].permute(1, 0, 2, 3).float()
    s = torch.einsum("bhgd,bhtd->bhgt", q.float(), k) * (D ** -0.5)
    t_pos = torch.arange(NP * page, device=q.device)
    mask = t_pos[None, None, None, :] < lengths.long()[:, None, None, None]
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)     # all-masked rows -> 0
    return torch.einsum("bhgt,bhtd->bhgd", p, v)


def embedding_bag_ref(table, indices, offsets, mode: str = "sum"):
    """CSR embedding bag: ``out[b]`` sums (``mode="mean"``: averages,
    an empty bag dividing by 1) the table rows
    ``indices[offsets[b]:offsets[b+1]]``.

    table: [R, D] (fp32 or bf16); indices, offsets: int32[N], int32[B+1]
    -> fp32 [B, D].  This mirrors the Pallas kernel's contract, not the
    JAX oracle's dtype: rows are widened to fp32 and summed in fp32, and
    the result is fp32, where the oracle sums in the table's dtype and
    returns it (the two agree for an fp32 table).  Indices clip into
    ``[0, R-1]`` as the oracle's ``mode="clip"`` does (the TPU kernel
    would read out of range).  Positions outside ``[offsets[0],
    offsets[B])`` belong to no bag.  A single-row bag equals
    ``table[idx].float()`` exactly.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', "
                         f"got {mode!r}")
    B = offsets.shape[0] - 1
    R, D = table.shape
    dev = table.device
    pos = torch.arange(indices.shape[0], device=dev)
    ends = offsets[1:].long()
    seg = torch.searchsorted(ends, pos, right=True)
    seg = torch.where(pos >= offsets[0].long(), seg, B)   # B: no bag
    rows = table[indices.long().clamp(0, R - 1)].float()
    out = torch.zeros((B + 1, D), dtype=torch.float32, device=dev)
    out.index_add_(0, seg, rows)
    out = out[:B]
    if mode == "mean":
        cnt = (ends - offsets[:-1].long()).clamp(min=1)
        out = out / cnt.float()[:, None]
    return out
