"""Plain torch versions of the port's CUDA kernels.

Each mirrors its reference oracle in the JAX package's
``kernels/ref.py``.  The CPU path runs them (``kernels.ops`` routes a CPU
tensor here), and the chip check holds every kernel against them on the
card.  uint32 values travel as int64 holding the value.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right

import torch

from repro_torch.kernels.paged_attention import PAGE
from repro_torch.kernels.postings_intersect import TILE
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


def intersect_tiles(a_row, b_row, tile: int = TILE, invalid: int = INVALID):
    """The CUDA kernel's partition of one row pair: ``(na_v, jlo, jhi,
    tiles)``.  ``na_v`` is a's valid length (its first ``invalid``),
    ``[jlo, jhi)`` the entries of b inside ``[a[0], a[na_v - 1]]``
    (lower and upper bound), and ``tiles`` the co-ranks ``(i0, i1, j0,
    j1)`` of each ``tile``-element diagonal of the merge of ``a[:na_v]``
    and ``b[jlo:jhi]``, b first on ties (j counts from jlo).  No tiles
    when either part is empty: the row is all pads."""
    A = a_row.tolist()
    na_v = bisect_left(A, invalid)
    if na_v == 0:
        return 0, 0, 0, []
    B = b_row.tolist()
    jlo, jhi = bisect_left(B, A[0]), bisect_right(B, A[na_v - 1])
    nb_r = jhi - jlo
    if nb_r == 0:
        return na_v, jlo, jhi, []

    def co_rank(k):
        # the a elements among the merge's first k: the smallest i with
        # b[jlo + k - i - 1] <= a[i] (that b element goes first)
        lo, hi = max(0, k - nb_r), min(k, na_v)
        while lo < hi:
            mid = (lo + hi) // 2
            if B[jlo + k - mid - 1] <= A[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo
    ks = list(range(0, na_v + nb_r, tile)) + [na_v + nb_r]
    cs = [co_rank(k) for k in ks]
    return na_v, jlo, jhi, [(i0, i1, k0 - i0, k1 - i1) for k0, i0, k1, i1
                            in zip(ks, cs, ks[1:], cs[1:])]


def intersect_mask_tiled_ref(a, b, tile: int = TILE, invalid: int = INVALID):
    """:func:`intersect_mask_ref` as the CUDA kernel computes it, tile by
    tile (a mirror for the tests).  Per row, the partition of
    :func:`intersect_tiles`; each tile stages ``b[jlo + j0 - 1]`` (or
    ``invalid`` before b's start) ahead of its own b elements, and
    ``a[i]`` is a hit when the staged element at the count of tile
    elements ``<= a[i]`` equals it.  Pad lanes and rows without tiles
    are 0."""
    out = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    na = a.shape[-1]
    if na == 0 or a.numel() == 0:
        return out
    a2, b2 = a.reshape(-1, na), b.reshape(-1, b.shape[-1])
    o2 = out.view(-1, na)
    for r in range(a2.shape[0]):
        _, jlo, _, tiles = intersect_tiles(a2[r], b2[r], tile, invalid)
        for i0, i1, j0, j1 in tiles:
            x = a2[r, i0:i1].contiguous()
            bt = b2[r, jlo + j0: jlo + j1].contiguous()
            g = jlo + j0 - 1
            sentinel = (b2[r, g: g + 1] if g >= 0 else
                        torch.full((1,), invalid, dtype=b.dtype,
                                   device=b.device))
            staged = torch.cat([sentinel, bt])
            cnt = torch.searchsorted(bt, x, right=True)
            o2[r, i0:i1] = (staged[cnt] == x).to(torch.int32)
    return out


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


def paged_attention_split_ref(q, k_heap, v_heap, page_table, lengths, S,
                              pps):
    """:func:`paged_attention_ref` as the CUDA kernel splits it: split s
    of a row walks pages ``[s * pps, (s + 1) * pps)`` into an fp32
    partial ``(m, l, acc)`` (an empty split: m = -inf, l = 0), and the
    partials merge in split order 0..S-1.  A mirror for the tests."""
    page = PAGE
    B, Hkv, G, D = q.shape
    NP = page_table.shape[1]
    ne = lengths.long().clamp(0, NP * page)[:, None, None, None]
    parts = []
    for s in range(S):
        cols = torch.arange(s * pps, min((s + 1) * pps, NP), device=q.device)
        if cols.numel() == 0:
            parts.append(None)
            continue
        pages = page_table[:, cols].long().clamp(min=0)
        slots = (pages[:, :, None] * page
                 + torch.arange(page, device=q.device)).reshape(B, -1)
        k = k_heap[:, slots].permute(1, 0, 2, 3).float()
        v = v_heap[:, slots].permute(1, 0, 2, 3).float()
        sc = torch.einsum("bhgd,bhtd->bhgt", q.float(), k) * (D ** -0.5)
        t_pos = s * pps * page + torch.arange(slots.shape[1], device=q.device)
        sc = torch.where(t_pos < ne, sc, float("-inf"))
        m = sc.amax(-1, keepdim=True)                      # [B, Hkv, G, 1]
        p = torch.where(m > float("-inf"), torch.exp(sc - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhgt,bhtd->bhgd", p, v)))
    m_all = torch.stack([pt[0] for pt in parts if pt is not None]).amax(0)
    live = m_all > float("-inf")
    l_sum = torch.zeros_like(m_all)
    acc = torch.zeros(B, Hkv, G, D, dtype=torch.float32, device=q.device)
    for pt in parts:                                     # split order
        if pt is None:
            continue
        w = torch.where(pt[0] > float("-inf"),
                        torch.exp(pt[0] - torch.where(live, m_all, 0.0)), 0.0)
        l_sum = l_sum + pt[1] * w
        acc = acc + pt[2] * w
    return torch.where(l_sum > 0, acc / torch.where(l_sum > 0, l_sum, 1.0),
                       0.0)


def _row_window(name, num_rows: int, row_lo: int, row_hi):
    """``(lo, hi)`` of a row window of a ``num_rows``-row table (the
    whole table by default), checked."""
    hi = num_rows if row_hi is None else int(row_hi)
    lo = int(row_lo)
    if not 0 <= lo <= hi <= num_rows:
        raise ValueError(f"{name}: row window [{lo}, {hi}) is not inside "
                         f"the table's {num_rows} rows")
    return lo, hi


def embedding_bag_ref(table, indices, offsets, mode: str = "sum", *,
                      row_lo: int = 0, row_hi=None, num_rows=None):
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

    A row window: ``table`` holds rows ``[row_lo, row_hi)`` of a table
    of ``num_rows`` rows (by default the whole table: ``row_lo`` 0,
    ``row_hi`` and ``num_rows`` the rows ``table`` has).  Ids clip into
    the whole table, and a clipped id outside the window adds nothing;
    the mean still divides by the bag's whole length.  Each bag is then
    the in-order sum of its rows that lie in the window, so the windows'
    bags over a split of the table sum to the whole bag (exactly for
    bags of one row); the whole window is today's call, bit for bit.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', "
                         f"got {mode!r}")
    B = offsets.shape[0] - 1
    n_local, D = table.shape
    if num_rows is None:
        num_rows = int(row_lo) + n_local
    lo, hi = _row_window("embedding_bag", num_rows, row_lo,
                         int(row_lo) + n_local if row_hi is None else row_hi)
    if hi - lo != n_local:
        raise ValueError(f"embedding_bag: a window of {hi - lo} rows for a "
                         f"table of {n_local}")
    R = num_rows
    dev = table.device
    pos = torch.arange(indices.shape[0], device=dev)
    ends = offsets[1:].long()
    seg = torch.searchsorted(ends, pos, right=True)
    seg = torch.where(pos >= offsets[0].long(), seg, B)   # B: no bag
    r = indices.long().clamp(0, R - 1)
    if (lo, hi) != (0, R):
        inside = (r >= lo) & (r < hi)
        seg = torch.where(inside, seg, B)
        r = torch.where(inside, r - lo, 0)
    rows = table[r].float()
    out = torch.zeros((B + 1, D), dtype=torch.float32, device=dev)
    out.index_add_(0, seg, rows)
    out = out[:B]
    if mode == "mean":
        cnt = (ends - offsets[:-1].long()).clamp(min=1)
        out = out / cnt.float()[:, None]
    return out


def embedding_bag_backward_ref(grad_out, indices, offsets, mode: str,
                               num_rows: int, dtype, *, row_lo: int = 0,
                               row_hi=None):
    """Gradient of :func:`embedding_bag_ref` with respect to its table:
    position j of bag b adds ``grad_out[b]`` (``mode="mean"``: divided by
    max(len_b, 1)) to row ``clip(indices[j], 0, R-1)``; positions outside
    ``[offsets[0], offsets[B])`` add nothing.

    grad_out: fp32 [B, D]; indices, offsets: int32[N], int32[B+1] ->
    ``[num_rows, D]`` in ``dtype``, dense (untouched rows zero), summed
    in fp32 in position order (``index_add_`` into zeros; on CUDA its
    atomics take any order) and cast once.  A row with one contribution
    is ``0.0 + g``: the kernel's bits.

    A row window ``[row_lo, row_hi)`` (the whole table by default) gives
    those rows of the gradient alone, ``[row_hi - row_lo, D]``: ids
    still clip into ``[0, num_rows - 1]``, and a position whose row lies
    outside the window adds nothing, so the windows of a split of the
    table concatenate to the whole gradient bit for bit."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag_backward: mode must be 'sum' or "
                         f"'mean', got {mode!r}")
    lo, hi = _row_window("embedding_bag_backward", num_rows, row_lo, row_hi)
    B = offsets.shape[0] - 1
    dev = grad_out.device
    pos = torch.arange(indices.shape[0], device=dev)
    ends = offsets[1:].long()
    seg = torch.searchsorted(ends, pos, right=True)
    inside = (pos >= offsets[0].long()) & (pos < offsets[B].long())
    g = grad_out.float()
    if mode == "mean":
        cnt = (ends - offsets[:-1].long()).clamp(min=1)
        g = g / cnt.float()[:, None]
    rows = indices.long().clamp(0, num_rows - 1)
    if (lo, hi) != (0, num_rows):
        inside = inside & (rows >= lo) & (rows < hi)
        rows = rows - lo
    out = torch.zeros((hi - lo, grad_out.shape[1]), dtype=torch.float32,
                      device=dev)
    out.index_add_(0, rows[inside], g[seg[inside]])
    return out.to(dtype)
