"""Sorted-set intersection mask (the paper's conjunctive-query step,
§3.1/§8), on CUDA.

Inputs are ASCENDING lists of uint32 docids (int64 tensors) padded with
INVALID (0xFFFFFFFF) — the query-engine representation.  The output is
an int32 membership mask over ``a`` (1 where a[i] is valid and present
in b); compaction happens in the caller (``core.query._compact``).  The
kernel (``csrc/postings_intersect.cu``) gives one thread to each element
of ``a`` and binary-searches ``b``; the plain torch version is
``kernels.ref.intersect_mask_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

INVALID = 0xFFFFFFFF


def pick_tile(n: int, preferred: int = 256) -> int:
    """Largest power-of-two tile <= ``preferred`` dividing ``n`` — the
    reference's tile rule, kept for API parity.  The CUDA kernel has no
    tiles (one thread per element of ``a``), so it takes no tile sizes.
    """
    t = min(preferred, n)
    while t > 1 and n % t:
        t //= 2
    return max(t, 1)


def intersect_mask(a, b):
    """Membership mask of ascending INVALID-padded ``a`` in ``b``.

    ``a``/``b`` are int64 ``[..., na]`` / ``[..., nb]`` with equal
    leading dims (one list pair per row); returns int32 ``[..., na]``.
    """
    name = "intersect_mask"
    _cuda.require_cuda(name, a, b)
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"{name}: a and b must be int64 (uint32 values)")
    na, nb = a.shape[-1], b.shape[-1]
    if a.shape[:-1] != b.shape[:-1]:
        raise ValueError(f"{name}: leading dims differ: {tuple(a.shape)} "
                         f"vs {tuple(b.shape)}")
    if nb == 0:
        raise ValueError(f"{name}: b must be non-empty")
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    rows = a.numel() // na if na else 0
    if rows == 0:
        return out
    intersect_mask.launches += 1
    err = _cuda.lib().intersect_mask_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, na, nb,
        _cuda.stream_ptr(a.device))
    _cuda.check(err, name)
    return out


intersect_mask.launches = 0
