"""CSR embedding bag, on CUDA.

Every table read of the recsys forwards (``models/recsys.py``) is one
launch of the kernel (``csrc/embedding_bag.cu``): one id per field is B·F
bags of one row, a pooled lookup is a bag of many rows.  Layout:

  table    [R, D]     fp32 or bf16
  indices  int32[N]   row ids, clipped into [0, R-1]
  offsets  int32[B+1] CSR bag boundaries
  out      [B, D]     fp32 sum (or mean: an empty bag divides by 1)

Each bag sums from its first row, one row at a time in bag order, so the
output is bit-identical from run to run and to a loop over the rows.
The launch's shape (:func:`launch_plan`) is chosen here from the shapes,
the table's base address and the SM count: the kernel only checks it.

The plain torch version is ``kernels.ref.embedding_bag_ref``;
``kernels.ops.embedding_bag`` routes by the table's device.

Both kernels take a row window for a table sharded by rows (a rank's
``[row_hi - row_lo, D]`` block of an ``[R, D]`` table; ``kernels.ops``
joins the ranks' partial bags): ids clip into the whole table, and a row
outside the window adds nothing to a bag and gets no gradient.  The
default window is the whole table, the unwindowed kernels' calls.

The table's gradient is a second kernel (``csrc/embedding_bag_backward.cu``,
:func:`embedding_bag_backward`): it sums each row's contributions in a
fixed order, bit-identical from run to run.  Its plain version is
``kernels.ref.embedding_bag_backward_ref``; ``kernels.ops.embedding_bag``
joins the two in an autograd function for a CUDA table that needs a
gradient.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _cuda

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"sum": 0, "mean": 1}
WARPS = 8              # warps per CTA (kWarps in the source)
CTAS_PER_SM = 3        # CTAs an SM holds at the kernel's register budget
MAX_BAGS = 128         # bags per chunk at most (kMaxBags)
ROWS_PER_LANE = 4      # rows each lane has in flight (kRows)
MAX_VEC = 4            # table elements per load at most
MAX_GRID = 1 << 20     # CTAs at most; their warps stride over the chunks


@dataclass(frozen=True)
class BagPlan:
    """How one launch cuts its work (see ``csrc/embedding_bag.cu``)."""
    vec_bytes: int       # bytes per row load: 16, 8, 4 or 2
    vec: int             # table elements per load
    lanes_per_row: int   # lanes that read one row side by side
    groups: int          # rows a warp reads side by side
    rows_per_lane: int   # rows each lane has in flight
    bags_per_chunk: int  # consecutive bags one warp takes at a time
    chunks: int
    grid: int            # CTAs of WARPS warps


def launch_plan(D: int, esize: int, base_ptr: int, n: int, B: int,
                sms: int) -> BagPlan:
    """The launch for a table of ``D`` columns of ``esize`` bytes at
    address ``base_ptr``, ``n`` indices and ``B`` bags on ``sms`` SMs.

    The row load is the widest of 16, 8, 4 and 2 bytes, at most
    ``MAX_VEC`` elements, that divides the row's byte width and the base
    address (a table view at an odd row or element takes a narrower
    load), so every row's loads are aligned.  A chunk is one tile of rows
    (groups x rows_per_lane) at the mean bag length ``n / B`` (shapes
    only: no host sync), at most ``MAX_BAGS`` bags.  A call of few bags
    takes one bag a warp when its bags are long; when its bags are single
    rows and a tile a warp would need a little more than one wave of
    CTAs, a warp takes two whole tiles (a second wave or a part-filled
    tile costs a second chain of dependent loads)."""
    vb = next((v for v in (16, 8, 4, 2)
               if esize <= v <= MAX_VEC * esize and (D * esize) % v == 0
               and base_ptr % v == 0), esize)
    vec = vb // esize
    lanes = min(32, -(-D // vec))
    groups = 32 // lanes
    mean_len = n / max(B, 1)
    tile = groups * ROWS_PER_LANE
    per_chunk = min(max(int(tile / max(mean_len, 1.0)), 1), MAX_BAGS)
    one_wave = -(-B // (CTAS_PER_SM * sms * WARPS))
    if mean_len > 1:
        per_chunk = max(1, min(per_chunk, one_wave))
    elif per_chunk < one_wave <= 2 * per_chunk:
        per_chunk = min(2 * per_chunk, MAX_BAGS)   # two whole tiles
    chunks = -(-B // per_chunk)
    grid = max(1, min(-(-chunks // WARPS), MAX_GRID))
    return BagPlan(vb, vec, lanes, groups, ROWS_PER_LANE, per_chunk, chunks,
                   grid)


def _window(name, n_local: int, row_lo: int, row_hi, num_rows):
    """``(lo, hi, R)`` of a ``n_local``-row block: rows ``[lo, hi)`` of an
    ``R``-row table (the whole table by default), checked."""
    lo = int(row_lo)
    hi = lo + n_local if row_hi is None else int(row_hi)
    R = hi if num_rows is None else int(num_rows)
    if not 0 <= lo <= hi <= R or hi - lo != n_local:
        raise ValueError(f"{name}: rows [{lo}, {hi}) of {R} for a block of "
                         f"{n_local} rows")
    return lo, hi, R


def embedding_bag(table, indices, offsets, mode: str = "sum", *,
                  row_lo: int = 0, row_hi=None, num_rows=None):
    """One launch of the CUDA kernel; see the module docstring.
    ``table`` holds rows ``[row_lo, row_hi)`` of a ``num_rows``-row table
    (by default the whole table)."""
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
    n_local, D = table.shape
    lo, hi, R = _window(name, n_local, row_lo, row_hi, num_rows)
    B = offsets.shape[0] - 1
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0 or D == 0:
        return out
    if n_local == 0:
        raise ValueError(f"{name}: an empty table has no row to read")
    plan = launch_plan(D, table.element_size(), table.data_ptr(),
                       indices.shape[0], B, _cuda.sm_count(table.device))
    embedding_bag.launches += 1
    err = _cuda.lib().embedding_bag_launch(
        table.data_ptr(), _BF16[table.dtype], indices.data_ptr(),
        indices.shape[0], offsets.data_ptr(), B, R, lo, hi, D, MODES[mode],
        plan.vec_bytes, plan.lanes_per_row, plan.bags_per_chunk, plan.grid,
        out.data_ptr(), _cuda.stream_ptr(table.device))
    _cuda.check(err, name)
    return out


embedding_bag.launches = 0


BWD_CHUNK = 32         # sorted entries per chunk (kChunk in the source)
BWD_WARPS = 8          # warps per CTA of its chunk kernels


@dataclass(frozen=True)
class BackwardPlan:
    """How one backward launch cuts its work (see
    ``csrc/embedding_bag_backward.cu``)."""
    vec: int             # fp32 columns per lane load
    lanes: int           # lanes that share one row
    n_chunks: int        # chunks of BWD_CHUNK sorted entries
    grid: int            # CTAs of BWD_WARPS warps for the chunk kernels


def backward_plan(D: int, grad_ptr: int, n: int,
                  shifted: bool = False) -> BackwardPlan:
    """The widest of 4, 2 and 1 fp32 a lane that divides ``D`` and the
    gradient's base address; a group of ``lanes`` lanes per chunk, as many
    groups a warp as fit.  A row window's chunks are shifted by its
    ``window_phase`` and need one chunk more (``shifted``)."""
    vec = next(v for v in (4, 2, 1) if D % v == 0 and grad_ptr % (4 * v) == 0)
    lanes = min(32, -(-D // vec))
    n_chunks = -(-n // BWD_CHUNK) + int(shifted)
    per_cta = (32 // lanes) * BWD_WARPS
    return BackwardPlan(vec, lanes, n_chunks,
                        max(1, min(-(-n_chunks // per_cta), MAX_GRID)))


def sort_positions(indices, offsets, num_rows: int, row_lo: int = 0,
                   row_hi=None):
    """The backward's sort: every position's clipped row (into
    ``[0, num_rows - 1]``) less ``row_lo``, or the window's row count
    ``row_hi - row_lo`` (the whole table by default) for a position
    outside ``[offsets[0], offsets[B])`` or whose row lies outside the
    window ``[row_lo, row_hi)``, sorted stably, and the positions in that
    order; int32 both.  No host sync."""
    n = indices.shape[0]
    hi = num_rows if row_hi is None else int(row_hi)
    pos = torch.arange(n, dtype=torch.int32, device=indices.device)
    inside = (pos >= offsets[0]) & (pos < offsets[-1])
    key = indices.clamp(0, num_rows - 1)
    if (row_lo, hi) != (0, num_rows):
        inside = inside & (key >= row_lo) & (key < hi)
        key = key - row_lo
    key = torch.where(inside, key, hi - row_lo)
    key, perm = torch.sort(key, stable=True)
    return key.to(torch.int32), perm.to(torch.int32)


def window_phase(indices, offsets, num_rows: int, row_lo: int):
    """The backward kernel's chunk shift for a window starting at row
    ``row_lo``: the in-bag positions whose clipped row lies below it, mod
    ``BWD_CHUNK`` (int32[1] on the device; no host sync), so the
    window's chunks fall where the whole table's sort puts them."""
    n = indices.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=indices.device)
    inside = (pos >= offsets[0]) & (pos < offsets[-1])
    below = inside & (indices.clamp(0, num_rows - 1) < row_lo)
    return (below.sum() % BWD_CHUNK).to(torch.int32).reshape(1)


def embedding_bag_backward(grad_out, indices, offsets, mode: str,
                           num_rows: int, dtype, *, row_lo: int = 0,
                           row_hi=None):
    """The table's gradient, ``[num_rows, D]`` in ``dtype`` (rows
    ``[row_lo, row_hi)`` of it alone, ``[row_hi - row_lo, D]``, for a
    window): one launch (the plan's sort, then the kernels); see
    ``csrc/embedding_bag_backward.cu``, which sees the window's rows as
    its table (the sort gives every other position the key "outside
    every bag")."""
    name = "embedding_bag_backward"
    _cuda.require_cuda(name, grad_out, indices, offsets)
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    if grad_out.dim() != 2 or grad_out.dtype != torch.float32 or \
            dtype not in _BF16:
        raise TypeError(f"{name}: grad_out must be float32 [B, D] and the "
                        f"table float32 or bfloat16")
    if indices.dtype != torch.int32 or offsets.dtype != torch.int32 or \
            indices.dim() != 1 or offsets.dim() != 1 or \
            offsets.shape[0] != grad_out.shape[0] + 1:
        raise TypeError(f"{name}: indices must be int32[N] and offsets "
                        f"int32[B + 1]")
    B, D = grad_out.shape
    R = int(num_rows)
    if R >= 2**31 - 1:
        raise ValueError(f"{name}: {R} rows do not fit int32 row keys")
    lo = int(row_lo)
    hi = R if row_hi is None else int(row_hi)
    if not 0 <= lo <= hi <= R:
        raise ValueError(f"{name}: rows [{lo}, {hi}) of {R}")
    dev = grad_out.device
    out = torch.empty((hi - lo, D), dtype=dtype, device=dev)
    if hi == lo or D == 0:
        return out
    n = indices.shape[0]
    key, perm = sort_positions(indices, offsets, R, lo, hi)
    windowed = (lo, hi) != (0, R)
    phase = window_phase(indices, offsets, R, lo) if windowed else None
    plan = backward_plan(D, grad_out.data_ptr(), n, shifted=windowed)
    bag_of = torch.empty(n, dtype=torch.int32, device=dev)
    head = torch.empty(plan.n_chunks * D, dtype=torch.float32, device=dev)
    tail = torch.empty_like(head)
    flags = torch.empty(plan.n_chunks, dtype=torch.uint8, device=dev)
    embedding_bag_backward.launches += 1
    err = _cuda.lib().embedding_bag_backward_launch(
        grad_out.data_ptr(), B, D, offsets.data_ptr(), key.data_ptr(),
        perm.data_ptr(), None if phase is None else phase.data_ptr(), n,
        hi - lo, MODES[mode], _BF16[dtype], plan.vec,
        plan.lanes, plan.grid, bag_of.data_ptr(), head.data_ptr(),
        tail.data_ptr(), flags.data_ptr(), out.data_ptr(),
        _cuda.sm_count(dev), _cuda.stream_ptr(dev))
    _cuda.check(err, name)
    return out


embedding_bag_backward.launches = 0
