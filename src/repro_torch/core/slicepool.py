"""Slice-pool allocator (paper §3.2-3.3), in torch.

Two BIT-IDENTICAL ingest implementations share one state layout: the
per-posting scan (:func:`make_ingest_fn`, the semantics oracle, run on
host mirrors of the state) and the batch-parallel bulk allocator
(:func:`make_bulk_ingest_fn`, the hot path — sorts a whole arrival
batch by term, walks the slice-size progression analytically, allocates
batch-wide and applies every write with one fused scatter-append
kernel).

The allocator state holds seven tensors:

  * ``heap``      — int64 (uint32 values) holding every pool back-to-back
                    (pool p occupies ``[base_p, base_p + slices_p * 2**z_p)``).
  * ``watermark`` — int32 next never-used slice per pool (bump allocation).
  * ``tail``      — int64 (uint32) per-term pointer to the most recently
                    written slot.
  * ``freq``      — int32 per-term posting count.
  * ``overflow``  — bool sticky bit; inserts that need an exhausted pool
                    become no-ops.
  * ``free_list`` / ``free_count`` — int32 per-pool LIFO stacks of
                    reclaimed slice indices (pool p owns region
                    ``[free_base_p, free_base_p + slices_p)``); rollover
                    returns a frozen segment's slices here
                    (:func:`release_slices`) and allocation pops them
                    before bumping the watermark.

Torch has no buffer donation: bulk ingest updates ``heap``/``tail``/
``freq`` IN PLACE and returns a state holding the same tensors, so a
caller rebinds ``state = ingest(state, ...)`` and keeps no alias of the
old state.  Zero-copy invariant (paper §3.2): a posting, once written,
is never moved within a segment's lifetime.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import pointers as ptr_mod
from repro_torch.core.pointers import NULL, U32, PoolLayout, decode_host

# Shared lru_cache bound for the function factories (ingest fns, query
# engines, qexec active-path fns): eviction costs a rebuild, never
# correctness.
FACTORY_CACHE_SIZE = 64
_BIG = (1 << 31) - 1


class PoolState(NamedTuple):
    heap: torch.Tensor        # int64[total_slots] (uint32 values)
    watermark: torch.Tensor   # int32[P] next never-used slice per pool
    tail: torch.Tensor        # int64[V] (uint32 pointers)
    freq: torch.Tensor        # int32[V]
    overflow: torch.Tensor    # bool[]
    free_list: torch.Tensor   # int32[total_slices] reclaimed slices
    free_count: torch.Tensor  # int32[P] live entries in each region


def init_state(layout: PoolLayout, vocab_size: int,
               device="cuda") -> PoolState:
    dev = torch.device(device)
    return PoolState(
        heap=torch.zeros((layout.total_slots,), dtype=torch.int64,
                         device=dev),
        watermark=torch.zeros((layout.num_pools,), dtype=torch.int32,
                              device=dev),
        tail=torch.full((vocab_size,), NULL, dtype=torch.int64, device=dev),
        freq=torch.zeros((vocab_size,), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        free_list=torch.zeros((layout.total_slices,), dtype=torch.int32,
                              device=dev),
        free_count=torch.zeros((layout.num_pools,), dtype=torch.int32,
                               device=dev),
    )


def init_sharded_state(layout: PoolLayout, vocab_size: int, n_shards: int,
                       device="cuda") -> PoolState:
    """``n_shards`` independent pools stacked on a leading shard axis:
    one allocation per leaf, shape ``[S, ...]`` (``overflow`` becomes
    ``bool[S]``).  Row ``s`` of every leaf is a contiguous view that is
    exactly a single-device state, so the bulk allocator writes a
    shard's batch in place through ``state.heap[s]`` and friends."""
    one = init_state(layout, vocab_size, "meta")
    dev = torch.device(device)
    return PoolState(*(
        torch.full((n_shards,) + tuple(x.shape), NULL if f == "tail" else 0,
                   dtype=x.dtype, device=dev)
        for f, x in zip(PoolState._fields, one)))


def shard_view(state: PoolState, s: int) -> PoolState:
    """Shard ``s`` of a stacked state, as views (writes land in it)."""
    return PoolState(*(leaf[s] for leaf in state))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def memory_slots_used(layout: PoolLayout, state: PoolState) -> int:
    """LIVE allocated slots = paper's empirical memory cost ``C_M*``
    (slices on the free list are not live).  Accepts a single state
    (``watermark[P]``) or a stacked one (``watermark[S, P]``); stacked
    states sum over shards."""
    live = (_np(state.watermark).astype(np.int64)
            - _np(state.free_count).astype(np.int64))
    return int(np.sum(live * np.asarray(layout.slice_sizes, np.int64)))


def memory_high_water_slots(layout: PoolLayout, state: PoolState) -> int:
    """Heap high-water mark: every slot that was EVER allocated (summed
    over shards for a stacked state)."""
    wm = _np(state.watermark).astype(np.int64)
    return int(np.sum(wm * np.asarray(layout.slice_sizes, np.int64)))


def shard_slots_used(layout: PoolLayout, state: PoolState) -> np.ndarray:
    """Per-shard LIVE allocated slots of a stacked state (int64[S])."""
    wm = _np(state.watermark).astype(np.int64)
    if wm.ndim != 2:
        raise ValueError("shard_slots_used wants a stacked state [S, P]")
    live = wm - _np(state.free_count).astype(np.int64)
    return np.sum(live * np.asarray(layout.slice_sizes, np.int64)[None, :],
                  axis=1)


def pool_utilization(layout: PoolLayout, state: PoolState) -> float:
    """Worst-case live-slice fill fraction across pools (and shards, for
    a stacked ``[S, P]`` state: the worst shard sets it): 1.0 means some
    pool has no allocatable slice left (the next allocation there trips
    the sticky ``overflow``).  One small host sync."""
    live = (_np(state.watermark).astype(np.float64)
            - _np(state.free_count).astype(np.float64))
    caps = np.asarray(layout.slices_per_pool, np.float64)
    return float(np.max(live / caps))


# ---------------------------------------------------------------------------
# The scan oracle: one posting at a time, on host mirrors of the state.
# ---------------------------------------------------------------------------
def _insert_one(layout: PoolLayout, st: dict, term: int, posting: int,
                start_pool: int, valid: bool) -> None:
    """One scan step, branch for branch the reference's ``_insert_one``,
    applied in place to ``st`` (numpy mirrors of the seven leaves).
    Reads clamp and writes past the end drop, like the reference's
    gathers and ``mode="drop"`` scatters."""
    P = layout.num_pools
    sizes = layout.slice_sizes
    heap, tail = st["heap"], st["tail"]
    total, V = heap.shape[0], tail.shape[0]

    def addr_of(pool, sl, off):
        p = min(pool, P - 1)
        return (layout.pool_base[p] + sl * sizes[p] + off) & U32

    t = int(tail[min(term, V - 1)])
    new = t == NULL
    pool, sl, off = decode_host(layout, t)
    full = (not new) and off == sizes[pool] - 1
    need_alloc = (new or full) and valid
    alloc_pool = start_pool if new else min(pool + 1, P - 1)
    ap = min(alloc_pool, P - 1)
    fc = int(st["free_count"][ap])
    has_free = fc > 0
    recycled = int(st["free_list"][layout.free_base[ap] + max(fc - 1, 0)])
    fresh = int(st["watermark"][ap])
    slice_new = (recycled if has_free else fresh) & U32
    can_alloc = has_free or fresh < layout.slices_per_pool[ap]
    ok = valid and (not need_alloc or can_alloc)
    do_alloc = need_alloc and ok
    if do_alloc and alloc_pool < P:
        if has_free:
            st["free_count"][alloc_pool] -= 1
        else:
            st["watermark"][alloc_pool] += 1
    has_ptr_slot = alloc_pool > 0
    w_pool = alloc_pool if do_alloc else pool
    w_slice = slice_new if do_alloc else sl
    w_off = (1 if has_ptr_slot else 0) if do_alloc else off + 1
    if do_alloc and has_ptr_slot:
        prev_addr = addr_of(alloc_pool, slice_new, 0)
        if prev_addr < total:
            heap[prev_addr] = NULL if new else t
    if ok:
        addr = addr_of(w_pool, w_slice, w_off)
        if addr < total:
            heap[addr] = posting & U32
    if term < V:
        if ok:
            tail[term] = ptr_mod.encode_host(
                layout, min(w_pool, P - 1), w_slice, w_off) & U32
            st["freq"][term] += 1
    if valid and need_alloc and not can_alloc:
        st["overflow"] = np.asarray(True)


_LEAVES = PoolState._fields


@functools.lru_cache(maxsize=FACTORY_CACHE_SIZE)
def make_ingest_fn(layout: PoolLayout, vocab_size: int):
    """Build ``ingest(state, terms, postings, start_pools, valid)``: the
    per-posting scan, the bulk allocator's semantics oracle.

    ``terms``/``postings`` are flat streams (one entry per term
    occurrence, already positional-encoded), ``start_pools`` implements
    the §7 SP policies (all zeros == ``SP(z_0)``), ``valid`` masks
    padding.  Returns a NEW state (the input is not modified).
    """
    def ingest(state: PoolState, terms, postings, start_pools=None,
               valid=None) -> PoolState:
        dev = state.heap.device
        st = {f: _np(getattr(state, f)).copy() for f in _LEAVES}
        t = _np(torch.as_tensor(terms)).astype(np.int64).tolist()
        p = _np(torch.as_tensor(postings)).astype(np.int64).tolist()
        n = len(t)
        sp = ([0] * n if start_pools is None
              else _np(torch.as_tensor(start_pools)).astype(np.int64)
              .tolist())
        va = ([True] * n if valid is None
              else _np(torch.as_tensor(valid)).astype(bool).tolist())
        for i in range(n):
            _insert_one(layout, st, t[i], p[i], sp[i], va[i])
        return PoolState(**{f: torch.from_numpy(np.asarray(st[f])).to(dev)
                            for f in _LEAVES})

    return ingest


# ---------------------------------------------------------------------------
# Batch-parallel bulk ingest (the hot path).
# ---------------------------------------------------------------------------
def _progression_tables(layout: PoolLayout):
    """Static §3.3 slice-size progression tables for the analytic walk.

    ``h[q]``          postings a FRESH slice in pool q holds (slot 0 of
                      pools > 0 is the previous-pointer).
    ``excl[q0, j]``   postings held by the first ``j`` fresh slices of the
                      progression ``q0, q0+1, ..., P-1, P-1, ...``.
    """
    P = layout.num_pools
    sizes = layout.slice_sizes
    h = np.asarray([sizes[q] - (1 if q > 0 else 0) for q in range(P)],
                   np.int64)
    excl = np.zeros((P, P + 1), np.int64)
    for q0 in range(P):
        acc = 0
        for j in range(P):
            excl[q0, j] = acc
            acc += h[min(q0 + j, P - 1)]
        excl[q0, P] = acc
    return h, excl


@functools.lru_cache(maxsize=FACTORY_CACHE_SIZE)
def make_bulk_ingest_fn(layout: PoolLayout, vocab_size: int,
                        device="cuda"):
    """Build the batch-parallel ``ingest`` — same signature and
    BIT-IDENTICAL ``PoolState`` as :func:`make_ingest_fn`'s scan, with
    one pass of vectorised tensor work per batch:

      1. stable-sort the (term, posting) stream by term (one int64 key
         packing (term, stream index) when it fits 32 bits, like the
         reference; a stable argsort otherwise); rank every occurrence
         within its term.
      2. walk the §3.3 slice-size progression ANALYTICALLY from each
         term's current ``tail``.
      3. allocate batch-wide: per pool, rank allocation events by stream
         position; free-list LIFO pops first, then watermark bumps;
         events past a pool's capacity fail, truncating their term from
         the failing posting onward and setting the sticky ``overflow``.
      4. write every posting, previous-pointer and new ``tail``/``freq``
         with one fused scatter-append (``kernels.ops.bulk_append``: the
         CUDA kernel for CUDA tensors, its plain version on the CPU).

    ``start_pools`` must be constant per term within a batch.  The
    state is updated IN PLACE (heap/tail/freq) and returned; callers
    rebind.  ``ingest.plan`` exposes step 1-3's scatter operands.
    """
    from repro_torch.kernels import ops as kops

    dev = torch.device(device)
    tbl = layout.tables(dev)
    pb = layout.pool_bits
    P = layout.num_pools
    V = vocab_size
    H = layout.total_slots
    caps = torch.tensor(layout.slices_per_pool, dtype=torch.int64,
                        device=dev)
    h_np, excl_np = _progression_tables(layout)
    h_tbl = torch.from_numpy(h_np).to(dev)
    excl_tbl = torch.from_numpy(excl_np).to(dev)
    hL = int(h_np[P - 1])
    pools = torch.arange(P, device=dev)

    def _plan(state: PoolState, terms, postings, start_pools, valid):
        """One batch -> scatter operands + the new small leaves.
        ``terms``/``postings``/``start_pools`` int64, ``valid`` bool."""
        N = terms.shape[0]
        i_idx = torch.arange(N, device=dev)
        last_i = max(N - 1, 0)
        # -- 1. sort by term (stable: stream order survives per term) ---
        key = torch.where(valid, terms, torch.full_like(terms, V))
        idx_bits = max((N - 1).bit_length(), 1)
        if V.bit_length() + idx_bits <= 32:
            skey = torch.sort((key << idx_bits) | i_idx).values
            order = skey & ((1 << idx_bits) - 1)
            t_s = skey >> idx_bits
        else:
            order = torch.sort(key, stable=True).indices
            t_s = key[order]
        post_s = postings[order]
        sp_s = start_pools[order]
        valid_s = valid[order]
        stream = order                                # original position
        head = torch.ones(N, dtype=torch.bool, device=dev)
        head[1:] = t_s[1:] != t_s[:-1]
        seg_id = torch.cumsum(head.long(), 0) - 1
        seg_start = torch.cummax(torch.where(head, i_idx, 0), 0).values
        r = i_idx - seg_start                         # rank within term

        # -- 2. analytic demand walk from each term's current tail ------
        tail_t = state.tail[t_s.clamp(max=V - 1)]
        new = tail_t == NULL
        cp, sl0, off0 = ptr_mod.decode(tbl, pb, tail_t)
        cap0 = tbl["slice_size"][cp]
        rem0 = torch.where(new, 0, cap0 - 1 - off0)
        sp_first = sp_s[seg_start].clamp(max=P - 1)
        q0 = torch.where(new, sp_first, (cp + 1).clamp(max=P - 1))
        ra = r - rem0                  # occurrence's rank past the tail
        needs = ra >= 0                # lands in a batch-fresh slice
        exq = excl_tbl[q0]                                   # [N, P+1]
        j_small = (exq[:, 1:] <= ra[:, None]).sum(1)
        beyond = ra >= exq[:, P]
        j = torch.where(beyond, P + (ra - exq[:, P]).clamp(min=0) // hL,
                        j_small)
        excl_at_j = torch.where(
            beyond, exq[:, P] + (j - P) * hL,
            torch.gather(exq, 1, j.clamp(0, P)[:, None])[:, 0])
        off_in = ra - excl_at_j        # posting's rank inside slice j
        pool_j = (q0 + j.clamp(max=P)).clamp(max=P - 1)
        is_event = valid_s & needs & (off_in == 0)   # slice-j allocation

        # -- 3. batch-wide allocation, pool by pool in stream order -----
        wm = state.watermark.long()
        fc = state.free_count.long()
        fb = tbl["free_base"]
        free_list = state.free_list
        total_slices = free_list.shape[0]
        inv = torch.empty(N, dtype=torch.int64, device=dev)
        inv[stream] = i_idx
        ev_o = is_event[inv]
        pool_o = torch.where(ev_o, pool_j[inv], P)    # P == no event
        avail = fc + caps - wm                         # [P]

        def _assign(k, pool, ok):
            """Slice id for the pool's ``k``-th allocation: free-list
            LIFO pop first, then watermark bump."""
            pool = pool.clamp(max=P - 1)
            pop_idx = (fb[pool] + fc[pool] - 1 - k).clamp(
                0, total_slices - 1)
            return torch.where(ok & (k < fc[pool]),
                               free_list[pop_idx].long(),
                               torch.where(ok, wm[pool] + k - fc[pool], 0))

        m_all = pool_o[None, :] == pools[:, None]              # [P, N]
        m_i = m_all.long()
        ranks = torch.cumsum(m_i, 1) - m_i
        # the single host sync of a batch: the fast/slow branch choice
        any_fail = bool((m_all & (ranks >= avail[:, None])).any())
        if not any_fail:
            # no event exceeds its pool: the assignment is exact
            k = torch.gather(ranks, 0, pool_o.clamp(max=P - 1)[None, :])[0]
            slice_o = _assign(k, pool_o, ev_o)
            n_succ = m_i.sum(1)
            failed_o = torch.zeros(N, dtype=torch.bool, device=dev)
            new_wm = wm + (n_succ - fc).clamp(min=0)
            new_fc = fc - torch.minimum(n_succ, fc)
        else:
            # exact overflow semantics: pools resolve in increasing
            # order; a failed slice truncates its term from that posting
            seg_o = seg_id[inv]
            failed_o = torch.zeros(N, dtype=torch.bool, device=dev)
            slice_o = torch.zeros(N, dtype=torch.int64, device=dev)
            new_wm, new_fc = wm.clone(), fc.clone()
            big = torch.full((N,), _BIG, dtype=torch.int64, device=dev)
            for p in range(P):
                m = (pool_o == p) & ~failed_o
                mi = m.long()
                k = torch.cumsum(mi, 0) - mi
                succ = m & (k < avail[p])
                fail = m & ~succ
                slice_o = torch.where(succ, _assign(k, pool_o, succ),
                                      slice_o)
                n_succ = succ.long().sum()
                new_wm[p] += (n_succ - fc[p]).clamp(min=0)
                new_fc[p] -= torch.minimum(n_succ, fc[p])
                fp = big.clone().scatter_reduce_(
                    0, seg_o, torch.where(fail, i_idx, big), "amin",
                    include_self=False)
                failed_o = failed_o | (i_idx >= fp[seg_o])

        evt_slice = slice_o[stream]          # back to term-sorted order
        failed_s = failed_o[stream]
        evt_ok = is_event & ~failed_s
        land = valid_s & ~failed_s

        # -- 4. scatter operands ----------------------------------------
        evt_pos = (i_idx - off_in).clamp(0, last_i)
        slice_occ = torch.where(needs, evt_slice[evt_pos], sl0)
        pool_occ = torch.where(needs, pool_j, cp)
        off_occ = torch.where(needs, off_in + (pool_j > 0).long(),
                              off0 + 1 + r)
        addr = ptr_mod.to_addr(tbl, pool_occ, slice_occ, off_occ)
        # skip rows get DISTINCT out-of-range addresses (H + row)
        post_addr = torch.where(land, addr, H + i_idx)
        post_val = post_s

        # previous-pointer writes: slot 0 of fresh slices in pools > 0
        pool_prev = (q0 + (j - 1).clamp(min=0)).clamp(max=P - 1)
        prev_evt = (i_idx - h_tbl[pool_prev]).clamp(0, last_i)
        prev_ptr = ptr_mod.encode(tbl, pb, pool_prev, evt_slice[prev_evt],
                                  tbl["slice_size"][pool_prev] - 1)
        # the first fresh slice links back to the pre-batch chain: by the
        # time that alloc fires, the old tail slice is FULL
        old_full = ptr_mod.encode(tbl, pb, cp, sl0,
                                  tbl["slice_size"][cp] - 1)
        ptr_val = torch.where(
            j == 0, torch.where(new, torch.full_like(old_full, NULL),
                                old_full), prev_ptr)
        ptr_write = evt_ok & (pool_j > 0)
        ptr_addr = torch.where(
            ptr_write,
            ptr_mod.to_addr(tbl, pool_j, evt_slice.clamp(min=0),
                            torch.zeros_like(pool_j)),
            H + i_idx)

        # per-term tail/freq: landed occurrences are a stream prefix
        is_last = torch.ones(N, dtype=torch.bool, device=dev)
        is_last[:-1] = head[1:]
        seg_end = torch.cummin(
            torch.where(is_last, i_idx, _BIG).flip(0), 0).values.flip(0)
        c = torch.cumsum(land.long(), 0)
        n_land = c[seg_end] - c[seg_start] + land[seg_start].long()
        last = (seg_start + n_land - 1).clamp(0, last_i)
        new_tail = ptr_mod.encode(tbl, pb, pool_occ[last], slice_occ[last],
                                  off_occ[last])
        write_term = head & valid_s & (n_land > 0)
        term_idx = torch.where(write_term, t_s, V + i_idx)
        term_freq = (state.freq[t_s.clamp(max=V - 1)].long()
                     + n_land).to(torch.int32)
        overflow = state.overflow | any_fail
        return ((post_addr, post_val, ptr_addr, ptr_val, term_idx, new_tail,
                 term_freq), new_wm.to(torch.int32),
                new_fc.to(torch.int32), overflow)

    def ingest(state: PoolState, terms, postings, start_pools=None,
               valid=None) -> PoolState:
        terms = torch.as_tensor(terms, device=dev).long()
        n = terms.shape[0]
        if n == 0:
            return state
        postings = torch.as_tensor(postings, device=dev).long()
        start_pools = (torch.zeros(n, dtype=torch.int64, device=dev)
                       if start_pools is None
                       else torch.as_tensor(start_pools, device=dev).long())
        valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
                 else torch.as_tensor(valid, device=dev).bool())
        scat, wm, fc, overflow = _plan(state, terms, postings, start_pools,
                                       valid)
        heap, tail, freq = kops.bulk_append(state.heap, state.tail,
                                            state.freq, *scat)
        return PoolState(heap, wm, tail, freq, overflow, state.free_list, fc)

    ingest.plan = _plan
    return ingest


# ---------------------------------------------------------------------------
# Slice reclamation (segment rollover -> free list).
# ---------------------------------------------------------------------------
def release_slices(layout: PoolLayout, state: PoolState, freed,
                   *, reset_terms: bool = True) -> PoolState:
    """Return reclaimed slices to the per-pool free lists (host-side).

    ``freed`` is a per-pool sequence of slice-index arrays — exactly what
    :func:`repro_torch.core.segments.freeze_state` reports; for a
    stacked state (leaves ``[S, ...]``) pass one such sequence per
    shard.  ``reset_terms`` clears ``tail``/``freq`` so the pool is an
    empty active segment again (heap contents stay: they were frozen
    into the read-only CSR segment, and recycled slices overwrite them
    lazily).
    """
    dev = state.heap.device
    wm = _np(state.watermark)
    fl = _np(state.free_list).copy()
    fc = _np(state.free_count).copy()
    base = np.asarray(layout.free_base, np.int64)
    caps = np.asarray(layout.slices_per_pool, np.int64)

    def _push(fl_row, fc_row, wm_row, per_pool):
        for p, sl in enumerate(per_pool):
            sl = np.asarray(sl, np.int32)
            if sl.size == 0:
                continue
            if np.unique(sl).size != sl.size:
                raise ValueError(
                    f"pool {p}: slice released twice in one call — "
                    f"double release?")
            held = fl_row[base[p]: base[p] + fc_row[p]]
            if np.intersect1d(sl, held).size:
                raise ValueError(
                    f"pool {p}: slice already on the free list — "
                    f"double release?")
            if int(sl.max()) >= int(wm_row[p]) or int(sl.min()) < 0:
                raise ValueError(
                    f"pool {p}: slice index outside the allocated range "
                    f"[0, {wm_row[p]}) — not this pool's slice")
            n = int(fc_row[p]) + sl.size
            if n > caps[p]:
                raise ValueError(
                    f"pool {p}: releasing {sl.size} slices overflows the "
                    f"free list ({fc_row[p]} held, capacity {caps[p]})")
            fl_row[base[p] + fc_row[p]: base[p] + n] = sl
            fc_row[p] = n

    if wm.ndim == 2:
        if len(freed) != wm.shape[0]:
            raise ValueError(f"{len(freed)} freed lists for a state of "
                             f"{wm.shape[0]} shards")
        for s, per_pool in enumerate(freed):
            _push(fl[s], fc[s], wm[s], per_pool)
    else:
        _push(fl, fc, wm, freed)
    tail, freq = state.tail, state.freq
    if reset_terms:
        tail = torch.full_like(state.tail, NULL)
        freq = torch.zeros_like(state.freq)
    return state._replace(free_list=torch.from_numpy(fl).to(dev),
                          free_count=torch.from_numpy(fc).to(dev),
                          tail=tail, freq=freq)


# ---------------------------------------------------------------------------
# Chain walking / materialisation.
# ---------------------------------------------------------------------------
def make_chain_walker(layout: PoolLayout, max_slices: int):
    """Build ``walk(state, terms) -> (bases, data_starts, last_offs,
    n_slices)`` over a tensor of terms of any shape: ``[..., max_slices]``
    slice tables newest-first, read by following each slice's
    previous-pointer in slot 0.  ``max_slices`` is a static bound
    (:func:`repro_torch.core.analytical.slices_needed` of the corpus max
    frequency).  The walk stops early once every chain has ended; the
    remaining entries are zeros either way."""
    pb = layout.pool_bits

    def walk(state: PoolState, term):
        dev = state.heap.device
        tbl = layout.tables(dev)
        heap = state.heap
        H = heap.shape[0]
        V = state.tail.shape[0]
        p = state.tail[term.long().clamp(0, V - 1)]
        bases, starts, lasts = [], [], []
        count = torch.zeros(term.shape, dtype=torch.int32, device=dev)
        for i in range(max_slices):
            live = p != NULL
            if i % 16 == 0 and i and not bool(live.any()):
                break
            pool, sl, off = ptr_mod.decode(tbl, pb, p)
            base = ptr_mod.to_addr(tbl, pool, sl, torch.zeros_like(sl))
            zero = torch.zeros_like(base)
            bases.append(torch.where(live, base, zero))
            starts.append(torch.where(live, (pool > 0).long(), zero))
            lasts.append(torch.where(live, off, zero))
            count += live.int()
            nxt = torch.where(pool > 0, heap[base.clamp(max=H - 1)],
                              torch.full_like(base, NULL))
            p = torch.where(live, nxt, p)
        pad = torch.zeros(term.shape + (max_slices - len(bases),),
                          dtype=torch.int64, device=dev)
        out = [torch.cat([torch.stack(x, -1), pad], -1)
               for x in (bases, starts, lasts)]
        return out[0], out[1], out[2], count

    return walk


def chain_lens_cum(starts, lasts, n_slices, max_slices: int):
    """Cumulative flattened lane counts of a walked chain: ``cum[..., i]``
    is the number of postings in the newest ``i + 1`` slices."""
    live = (torch.arange(max_slices, device=starts.device)
            < n_slices[..., None])
    lens = torch.where(live, lasts - starts + 1, 0)
    return torch.cumsum(lens, -1)


def chain_window_addrs(bases, lasts, cum, lanes, max_slices: int):
    """Heap addresses of reverse-chronological lanes ``lanes`` (``[...,
    L]``, leading dims matching ``cum``'s) of a walked chain.  Lanes >=
    the chain's total yield garbage addresses — callers mask by it."""
    s = torch.searchsorted(cum.contiguous(), lanes.contiguous(), right=True)
    s = s.clamp_(max=max_slices - 1)
    before = torch.where(
        s > 0, torch.gather(cum, -1, (s - 1).clamp(min=0)), 0)
    within = lanes - before
    return (torch.gather(bases, -1, s) + torch.gather(lasts, -1, s)
            - within) & U32


def make_materializer(layout: PoolLayout, max_slices: int, max_len: int):
    """Build ``materialize(state, terms) -> (postings_desc, length)``:
    each term's postings reverse-chronologically, ``[..., max_len]``
    zero-padded, plus the (max_len-capped) count.  Two-phase: an
    O(#slices) chain walk, then one vectorised gather."""
    walk = make_chain_walker(layout, max_slices)

    def materialize(state: PoolState, term):
        bases, starts, lasts, n = walk(state, term)
        cum = chain_lens_cum(starts, lasts, n, max_slices)
        total = cum[..., -1].clamp(max=max_len)
        j = torch.arange(max_len, device=cum.device)
        lanes = j.expand(cum.shape[:-1] + (max_len,))
        addr = chain_window_addrs(bases, lasts, cum, lanes, max_slices)
        vals = state.heap[addr.clamp_(max=state.heap.shape[0] - 1)]
        vals = torch.where(j < total[..., None], vals, 0)
        return vals, total

    return materialize
