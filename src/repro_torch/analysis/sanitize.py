"""Sanitized calls of the kernels' plain versions.

Torch has no ``checkify``, so the reference package's checked route is
rebuilt from explicit assertions.  ``kernels.ops.<kernel>(...,
checked=True)`` runs the call as ``ops`` routes it by device (the CUDA
kernel for CUDA tensors, the plain version from
:mod:`repro_torch.kernels.ref` for CPU tensors) under three classes of
check, the ones an allocator bug (dangling pointer, bad watermark,
zero-width slice) shows up as:

  * **index bounds** — asserted on the inputs BEFORE the call runs,
    because the plain versions clamp their gathers (the slab window of
    a block's gap plane, the membership probe) and would hide the
    fault, and a kernel must not read out of bounds;
  * **NaN** — any floating output holding a NaN;
  * **zero division** — an integer division by zero inside the call (the
    CPU raises it; the card does not trap it).

A violation raises :class:`SanitizerError`.  Usage::

    from repro_torch.analysis import sanitize
    safe = sanitize.sanitized(ref.segment_intersect_mask_batched_ref,
                              precheck=sanitize.stacked_pair_bounds)
    masks = safe(stacked_a, stacked_b)
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.segment_intersect import (SCORE_WORDS, SLAB_WORDS)


class SanitizerError(RuntimeError):
    """An index-bounds, NaN or zero-division check failed."""


def check_index(name: str, idx, size: int) -> None:
    """Every entry of ``idx`` must address ``[0, size)``."""
    if idx.numel() and bool(((idx < 0) | (idx >= size)).any()):
        lo, hi = int(idx.min()), int(idx.max())
        raise SanitizerError(f"{name}: index out of bounds: values in "
                             f"[{lo}, {hi}] against a length of {size}")


def check_windows(name: str, woffs, n_words: int) -> None:
    """Each block's ``SLAB_WORDS``-word window ``[woff, woff +
    SLAB_WORDS)`` must lie inside a payload of ``n_words`` words."""
    check_index(name + ".woffs (window start)", woffs,
                n_words - SLAB_WORDS + 1)


def _check_rows(name: str, a, b) -> None:
    if a.shape[:-1] != b.shape[:-1]:
        raise SanitizerError(f"{name}: leading dims {tuple(a.shape[:-1])} "
                             f"!= {tuple(b.shape[:-1])}")


def list_pair_bounds(a, b) -> None:
    """``intersect_mask``: rows of ``a`` and ``b`` pair up and ``b`` has
    an entry to probe."""
    _check_rows("intersect_mask", a, b)
    if a.shape[-1] and not b.shape[-1]:
        raise SanitizerError("intersect_mask: probing an empty b")


def packed_pair_bounds(a, b) -> None:
    """``segment_intersect_mask``: every block window in its payload."""
    for tag, p in (("a", a), ("b", b)):
        p = p.to("cpu") if not isinstance(p.firsts, torch.Tensor) else p
        check_windows(f"segment_intersect_mask.{tag}", p.woffs,
                      p.payload.shape[-1])


def stacked_pair_bounds(a, b) -> None:
    """``segment_intersect_mask_batched``: rows pair up and every block
    window lies in its row's payload."""
    name = "segment_intersect_mask_batched"
    _check_rows(name, a.firsts, b.firsts)
    for tag, s in (("a", a), ("b", b)):
        check_windows(f"{name}.{tag}", s.woffs, s.payload.shape[-1])


def scored_pair_bounds(a, b, rest, th) -> None:
    """``scored_intersect_batched``: the docid stacks as
    :func:`stacked_pair_bounds`, score planes and block maxima as wide as
    the blocks, one ``rest`` and ``th`` per row."""
    name = "scored_intersect_batched"
    stacked_pair_bounds(a.ids, b.ids)
    for tag, s in (("a", a), ("b", b)):
        nb = s.ids.firsts.shape[-1]
        if s.swords.shape[-1] != nb * SCORE_WORDS or \
                s.bmax.shape[-1] != nb:
            raise SanitizerError(f"{name}.{tag}: score planes "
                                 f"{tuple(s.swords.shape)} / block maxima "
                                 f"{tuple(s.bmax.shape)} for {nb} blocks")
    rows = a.ids.firsts.shape[0]
    for tag, v in (("rest", rest), ("th", th)):
        if tuple(v.shape) != (rows,):
            raise SanitizerError(f"{name}.{tag}: shape {tuple(v.shape)} "
                                 f"!= ({rows},)")


def bulk_append_bounds(heap, tail, freq, post_addr, post_val, ptr_addr,
                       ptr_val, term_idx, term_tail, term_freq) -> None:
    """``bulk_append``: every lane must land.  Stricter than the
    scatter's skip contract, exactly as the reference's checked route:
    the allocator encodes skip lanes as out-of-range addresses, so a
    batch with skips raises; use it to audit batches meant to be dense."""
    check_index("bulk_append.post_addr", post_addr, heap.shape[0])
    check_index("bulk_append.ptr_addr", ptr_addr, heap.shape[0])
    check_index("bulk_append.term_idx", term_idx,
                min(tail.shape[0], freq.shape[0]))


def _no_nan(name: str, out) -> None:
    if isinstance(out, (tuple, list)):
        for o in out:
            _no_nan(name, o)
    elif isinstance(out, torch.Tensor) and out.is_floating_point() \
            and bool(torch.isnan(out).any()):
        raise SanitizerError(f"{name}: NaN in the output")


def sanitized(fn, *, precheck=None):
    """Wrap ``fn`` so each call asserts ``precheck(*args)`` first, then
    runs ``fn`` and asserts its output holds no NaN; an integer division
    by zero inside ``fn`` becomes :class:`SanitizerError` too."""
    name = getattr(fn, "__name__", "call")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if precheck is not None:
            precheck(*args, **kwargs)
        try:
            out = fn(*args, **kwargs)
        except (RuntimeError, ZeroDivisionError) as exc:
            if "ZeroDivision" in type(exc).__name__ + str(exc):
                raise SanitizerError(f"{name}: division by zero") from exc
            raise
        _no_nan(name, out)
        return out

    return wrapper


def checked_call(fn, *args, precheck=None, **kwargs):
    """One-shot :func:`sanitized`: check, call, return or raise."""
    return sanitized(fn, precheck=precheck)(*args, **kwargs)


__all__ = ["SanitizerError", "bulk_append_bounds", "check_index",
           "check_windows", "checked_call", "list_pair_bounds",
           "packed_pair_bounds", "sanitized", "scored_pair_bounds",
           "stacked_pair_bounds"]
