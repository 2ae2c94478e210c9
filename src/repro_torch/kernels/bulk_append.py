"""Fused scatter-append for bulk ingest (paper §3.2 hot path), on CUDA.

One kernel (``csrc/bulk_append.cu``) applies a whole ingest batch's
writes to the live pool state in place: every posting value at its
precomputed heap slot, every fresh slice's previous-pointer, and every
touched term's new ``tail`` pointer and ``freq`` count.  The bulk
allocator (``slicepool.make_bulk_ingest_fn``) does all address
arithmetic up front; skips are out-of-range addresses
(``addr >= len(target)``).  The launch's shape (:func:`launch_plan`) is
chosen here from the lane count, the SM count and the streams'
addresses: the kernel only checks it.  The plain torch version is
``kernels.ref.bulk_append_ref``; ``kernels.ops.bulk_append`` routes by
the tensors' device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _cuda

WARPS = 8              # warps per CTA (kWarps in the source)
THREADS = 32 * WARPS
CTAS_PER_SM = 5        # CTAs an SM holds at the kernel's register budget
LANES = 2              # lanes a thread: one 16-byte load of an int64 stream
TILE = 32 * LANES      # lanes a warp tile (kTile in the source)
# element bytes of the seven streams, in the kernel's argument order:
# post_addr, post_val, ptr_addr, ptr_val, term_idx, term_tail, term_freq
STREAM_BYTES = (8, 8, 8, 8, 8, 8, 4)


@dataclass(frozen=True)
class AppendPlan:
    """How one launch cuts its lanes (see ``csrc/bulk_append.cu``)."""
    lanes_per_thread: int  # LANES: a pair of lanes a thread
    threads: int           # a CTA
    grid: int              # CTAs, at most one wave
    aligned: int           # bit s: stream s is read two lanes a load
    tile: int              # lanes a warp tile (32 x lanes_per_thread)
    tiles: int             # warp tiles over the n lanes


def launch_plan(n: int, sms: int, ptrs) -> AppendPlan:
    """The launch for ``n >= 1`` lanes on ``sms`` SMs, the seven streams'
    ``data_ptr``s ``ptrs`` in the kernel's order.

    A thread holds two lanes, a warp a tile of 64.  The grid is the CTAs
    the tiles need, at most ``CTAS_PER_SM`` an SM, so it is one wave
    (phase 2's 286,720 lanes take 560 CTAs of the 660 that 132 SMs hold);
    warps walk tiles past the grid grid-stride.  A stream is read two
    lanes a load where its base is aligned to two elements (16 bytes; 8
    for the int32 ``term_freq``), else one lane a load (a view at an odd
    element)."""
    if n < 1:
        raise ValueError(f"launch_plan: n must be >= 1, got {n}")
    if len(ptrs) != len(STREAM_BYTES):
        raise ValueError(f"launch_plan: {len(ptrs)} stream addresses, "
                         f"expected {len(STREAM_BYTES)}")
    tiles = -(-n // TILE)
    grid = max(1, min(-(-tiles // WARPS), CTAS_PER_SM * sms))
    aligned = sum(1 << s for s, (p, b) in enumerate(zip(ptrs, STREAM_BYTES))
                  if p % (LANES * b) == 0)
    return AppendPlan(LANES, THREADS, grid, aligned, TILE, tiles)


def bulk_append(heap, tail, freq, post_addr, post_val, ptr_addr, ptr_val,
                term_idx, term_tail, term_freq):
    """Apply one ingest batch's scatters to (heap, tail, freq) in place
    and return them.  ``heap``/``tail``/the value and address streams
    are int64 (uint32 values); ``freq``/``term_freq`` are int32; the
    seven streams share one length."""
    name = "bulk_append"
    ops = (heap, tail, freq, post_addr, post_val, ptr_addr, ptr_val,
           term_idx, term_tail, term_freq)
    _cuda.require_cuda(name, *ops)
    for t, dt in zip(ops, (torch.int64, torch.int64, torch.int32)
                     + (torch.int64,) * 6 + (torch.int32,)):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
    n = post_addr.shape[0]
    if any(t.shape != (n,) for t in ops[3:]):
        raise ValueError(f"{name}: the seven streams must be 1-D of one "
                         f"length")
    if tail.shape != freq.shape or heap.dim() != 1 or tail.dim() != 1:
        raise ValueError(f"{name}: heap, tail and freq must be 1-D with "
                         f"len(tail) == len(freq)")
    if n == 0:
        return heap, tail, freq
    streams = [t.data_ptr() for t in ops[3:]]
    plan = launch_plan(n, _cuda.sm_count(heap.device), streams)
    bulk_append.launches += 1
    err = _cuda.lib().bulk_append_launch(
        heap.data_ptr(), heap.shape[0], tail.data_ptr(), freq.data_ptr(),
        tail.shape[0], *streams, n, plan.tile, plan.grid, plan.aligned,
        _cuda.stream_ptr(heap.device))
    _cuda.check(err, name)
    return heap, tail, freq


bulk_append.launches = 0
