"""CSR embedding bag, on CUDA.

Every table read of the recsys forwards (``models/recsys.py``) is one
launch of the kernel (``csrc/embedding_bag.cu``): one id per field is B·F
bags of one row, a pooled lookup is a bag of many rows.  Layout:

  table    [R, D]     fp32 or bf16
  indices  int32[N]   row ids, clipped into [0, R-1]
  offsets  int32[B+1] CSR bag boundaries
  out      [B, D]     fp32 sum (or mean: an empty bag divides by 1)

The plain torch version is ``kernels.ref.embedding_bag_ref``;
``kernels.ops.embedding_bag`` routes by the table's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"sum": 0, "mean": 1}


def embedding_bag(table, indices, offsets, mode: str = "sum"):
    """One launch of the CUDA kernel; see the module docstring."""
    name = "embedding_bag"
    _cuda.require_cuda(name, table, indices, offsets)
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    if table.dim() != 2 or table.dtype not in _BF16:
        raise TypeError(f"{name}: the table must be a float32 or bfloat16 "
                        f"[R, D] matrix")
    if indices.dtype != torch.int32 or offsets.dtype != torch.int32 or \
            indices.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
        raise TypeError(f"{name}: indices must be int32[N] and offsets "
                        f"int32[B + 1]")
    R, D = table.shape
    B = offsets.shape[0] - 1
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0 or D == 0:
        return out
    if R == 0:
        raise ValueError(f"{name}: an empty table has no row to read")
    embedding_bag.launches += 1
    err = _cuda.lib().embedding_bag_launch(
        table.data_ptr(), _BF16[table.dtype], indices.data_ptr(),
        indices.shape[0], offsets.data_ptr(), B, R, D, MODES[mode],
        out.data_ptr(), _cuda.stream_ptr(table.device))
    _cuda.check(err, name)
    return out


embedding_bag.launches = 0
