"""Fused scatter-append for bulk ingest (paper §3.2 hot path), on CUDA.

One kernel (``csrc/bulk_append.cu``) applies a whole ingest batch's
writes to the live pool state in place: every posting value at its
precomputed heap slot, every fresh slice's previous-pointer, and every
touched term's new ``tail`` pointer and ``freq`` count.  The bulk
allocator (``slicepool.make_bulk_ingest_fn``) does all address
arithmetic up front; skips are out-of-range addresses
(``addr >= len(target)``).  The plain torch version is
``kernels.ref.bulk_append_ref``; ``kernels.ops.bulk_append`` routes by
the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda


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
    bulk_append.launches += 1
    err = _cuda.lib().bulk_append_launch(
        heap.data_ptr(), heap.shape[0], tail.data_ptr(), freq.data_ptr(),
        tail.shape[0], post_addr.data_ptr(), post_val.data_ptr(),
        ptr_addr.data_ptr(), ptr_val.data_ptr(), term_idx.data_ptr(),
        term_tail.data_ptr(), term_freq.data_ptr(), n,
        _cuda.stream_ptr(heap.device))
    _cuda.check(err, name)
    return heap, tail, freq


bulk_append.launches = 0
