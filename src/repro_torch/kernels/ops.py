"""Device routing for the port's kernels.

Each call goes by the device of its tensors: a CPU tensor runs the plain
torch version (``kernels.ref``), a CUDA tensor runs the hand-written
kernel, and any other device raises.  There is no fallback from the
kernel to the plain version: a CUDA call whose kernel cannot build or
launch raises.  Every kernel wrapper counts its launches in a plain
integer attribute ``launches`` (:func:`launch_counts`).

``checked=True`` on the postings, segment and bulk-append wrappers asks
for the sanitized route (:mod:`repro_torch.analysis.sanitize`): the
inputs' index bounds are asserted first, then the call is routed by
device as above (a CUDA tensor launches, and counts, the kernel), then
its output is checked for NaN.  A failed check raises
``SanitizerError``; a call that fails the bounds launches nothing.

``embedding_bag`` is differentiable in its table on both devices: on the
CPU through autograd over the plain version, on CUDA through
:class:`_BagFunction`, whose backward is the hand-written
``embedding_bag_backward`` kernel.

A ``DTensor`` table (the recsys steps on a mesh of ranks) is replicated
or sharded by rows (``Shard(0)`` on the mesh dims the logical ``rows``
axis maps to; ``Shard(1)`` raises). Each rank bags its own block of
rows, ``[lo, hi)`` of the whole table, through the same kernels with a
row window: ids clip into the whole table, and an id outside the window
adds nothing (:class:`_BagFunction`: the windowed kernel on CUDA, the
windowed plain version on the CPU). The ranks' partial fp32 bags are
summed over the rows' mesh dims by ``dist.collectives.mesh_psum(x,
"rows")``, on local tensors, staged through the host over gloo (never a
``DTensor`` collective: gloo's crash on CUDA tensors). A mean divides
each partial by the bag's whole length, so the sum is the mean. Indices
sharded by the batch over a mesh dim the rows also shard (``rows ->
("data", "model")``) are first gathered over it (the same family), and
each rank keeps its own batch's bags after the sum; indices sharded over
other dims stay local, their CSR offsets rebased to the block. The bags
come back as a ``DTensor`` with the batch's placements (replicated over
the rows' dims). The backward runs the windowed backward kernel on this
rank's rows alone and returns a ``[hi - lo, D]`` block laid out as the
table (``Shard(0)``; a partial sum over the dims that split the batch
and not the rows, which the step reduces as any gradient). The bags'
gradient is the same on every rank of the rows' group: one that an op
hands back with other placements is laid out anew by
``collectives.local_as``, and a gathered batch's is gathered the same
way. A replicated table bags its local tensor and sends nothing. Sharded
bags sum in another order than one device's, so bags of several rows
agree within fp32 rounding; a bag of one row is exact (one rank adds
it).

A ``meta`` table (the dry-run, ``launch/dryrun.py``) takes a shape-only
route: two custom ops, ``repro_torch::bag_shape`` and its gradient
``repro_torch::bag_grad_shape``, whose fake implementations give the
output's shape and dtype and whose real ones raise, so no device ever
runs them.  A ``meta`` ``DTensor`` table takes the sharded route above
with these ops in the kernels' place on its local tensors, so the
dry-run counts the real route's collectives (the gather, the reduce
over the rows' dims, the gradient's layout) and no ``DTensor`` sharding
rule of its own stands in for them.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.analysis import sanitize
from repro_torch.kernels import bulk_append as _ba
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import postings_intersect as _pi
from repro_torch.kernels import ref
from repro_torch.kernels import segment_intersect as _si

KERNELS = {
    "bulk_append": _ba.bulk_append,
    "segment_intersect_mask_batched": _si.segment_intersect_mask_batched,
    "intersect_mask": _pi.intersect_mask,
    "segment_intersect_mask": _si.segment_intersect_mask,
    "scored_intersect_batched": _si.scored_intersect_batched,
    "paged_attention": _pa.paged_attention,
    "embedding_bag": _eb.embedding_bag,
    "embedding_bag_backward": _eb.embedding_bag_backward,
}


@torch.library.custom_op("repro_torch::bag_shape", mutates_args=())
def _bag_shape(table: torch.Tensor, indices: torch.Tensor,
               offsets: torch.Tensor, mode: str) -> torch.Tensor:
    raise RuntimeError("repro_torch::bag_shape is a shape-only route: "
                       "meta tensors only")


@_bag_shape.register_fake
def _(table, indices, offsets, mode):
    return table.new_empty((offsets.shape[0] - 1, table.shape[1]),
                           dtype=torch.float32)


@torch.library.custom_op("repro_torch::bag_grad_shape", mutates_args=())
def _bag_grad_shape(grad: torch.Tensor, table: torch.Tensor,
                    indices: torch.Tensor, offsets: torch.Tensor,
                    mode: str) -> torch.Tensor:
    raise RuntimeError("repro_torch::bag_grad_shape is a shape-only route: "
                       "meta tensors only")


@_bag_grad_shape.register_fake
def _(grad, table, indices, offsets, mode):
    return torch.empty_like(table)


def _bag_shape_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:3])
    ctx.mode = inputs[3]


def _bag_shape_backward(ctx, grad):
    table, indices, offsets = ctx.saved_tensors
    return (_bag_grad_shape(grad, table, indices, offsets, ctx.mode),
            None, None, None)


_bag_shape.register_autograd(_bag_shape_backward,
                             setup_context=_bag_shape_setup)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _on_cuda(name: str, t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def intersect_mask(a, b, *, checked: bool = False):
    """Membership mask of ascending INVALID-padded ``a`` in ``b``."""
    if checked:
        return sanitize.checked_call(intersect_mask, a, b,
                                     precheck=sanitize.list_pair_bounds)
    if _on_cuda("intersect_mask", a):
        return _pi.intersect_mask(a.contiguous(), b.contiguous())
    return ref.intersect_mask_ref(a, b)


def segment_intersect_mask(a, b, *, checked: bool = False):
    """Fused gap-decode + intersection of two torch-leaved PackedLists."""
    if checked:
        return sanitize.checked_call(segment_intersect_mask, a, b,
                                     precheck=sanitize.packed_pair_bounds)
    if _on_cuda("segment_intersect_mask", a.firsts):
        return _si.segment_intersect_mask(a, b)
    return ref.segment_intersect_mask_ref(a, b)


def segment_intersect_mask_batched(a, b, *, checked: bool = False):
    """Row-wise masks of a whole (query, segment) batch of StackedLists."""
    if checked:
        return sanitize.checked_call(
            segment_intersect_mask_batched, a, b,
            precheck=sanitize.stacked_pair_bounds)
    if _on_cuda("segment_intersect_mask_batched", a.firsts):
        return _si.segment_intersect_mask_batched(a, b)
    return ref.segment_intersect_mask_batched_ref(a, b)


def scored_intersect_batched(a, b, rest, th, *, checked: bool = False):
    """Row-wise scored conjunction over a (query, segment) batch of
    ScoredStacks: impact sums for a-docids present in b, with whole
    a-blocks zeroed when their block-max WAND bound ``a.bmax + rest``
    cannot beat the heap threshold ``th`` (int32[N] each; th = -1
    disables skipping)."""
    if checked:
        return sanitize.checked_call(
            scored_intersect_batched, a, b, rest, th,
            precheck=sanitize.scored_pair_bounds)
    if _on_cuda("scored_intersect_batched", a.ids.firsts):
        return _si.scored_intersect_batched(a, b, rest, th)
    return ref.scored_intersect_batched_ref(a, b, rest, th)


def bulk_append(heap, tail, freq, post_addr, post_val, ptr_addr, ptr_val,
                term_idx, term_tail, term_freq, *, checked: bool = False):
    """Fused scatter-append of one ingest batch into (heap, tail, freq),
    in place.  ``checked=True`` is stricter than the skip contract:
    every lane must land (``sanitize.bulk_append_bounds``)."""
    args = (heap, tail, freq, post_addr, post_val, ptr_addr, ptr_val,
            term_idx, term_tail, term_freq)
    if checked:
        return sanitize.checked_call(bulk_append, *args,
                                     precheck=sanitize.bulk_append_bounds)
    if _on_cuda("bulk_append", heap):
        return _ba.bulk_append(*args)
    return ref.bulk_append_ref(*args)


def paged_attention(q, k_heap, v_heap, page_table, lengths):
    """Decode attention of q [B, Hkv, G, D] through a page table over
    [Hkv, slots, D] K/V heaps; fp32 [B, Hkv, G, D]."""
    if _on_cuda("paged_attention", q):
        return _pa.paged_attention(q.contiguous(), k_heap, v_heap,
                                   page_table.contiguous(),
                                   lengths.contiguous())
    return ref.paged_attention_ref(q, k_heap, v_heap, page_table, lengths)


class _BagFunction(torch.autograd.Function):
    """The bag with its table's gradient, on plain (local) tensors:
    forward the bag of the table's rows ``[lo, hi)`` of ``R`` (``win``;
    the kernel on CUDA, the plain version on the CPU, the shape-only op
    on ``meta``), on a row-sharded table summed over the rows' ranks
    (``rows``: ``mesh_psum``) and cut to this rank's bags where the
    indices were gathered (``gather``); backward the gradient gathered
    back the same way and the windowed backward, ``[hi - lo, D]`` (the
    indices and offsets get no gradient).  A plain CUDA table is the
    whole window with neither."""

    @staticmethod
    def forward(ctx, table, indices, offsets, mode, win, rows, gather):
        from repro_torch.dist import collectives as C
        lo, hi, R = win
        ctx.save_for_backward(indices, offsets)
        ctx.mode, ctx.win, ctx.dtype, ctx.gather = mode, win, table.dtype, \
            gather
        ctx.meta = table if table.device.type == "meta" else None
        if ctx.meta is not None:                 # the dry-run: shapes only
            bags = _bag_shape(table, indices, offsets, mode)
        elif _on_cuda("embedding_bag", table):
            bags = _eb.embedding_bag(table, indices, offsets, mode,
                                     row_lo=lo, row_hi=hi, num_rows=R)
        else:
            bags = ref.embedding_bag_ref(table, indices, offsets, mode,
                                         row_lo=lo, row_hi=hi, num_rows=R)
        if rows is not None:
            bags = C.mesh_psum(bags, "rows", rules=rows)
        if gather is not None:
            k, n = gather[1], gather[2]
            per = bags.shape[0] // n
            bags = bags[k * per:(k + 1) * per].contiguous()
        return bags

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.dist import collectives as C
        indices, offsets = ctx.saved_tensors
        lo, hi, R = ctx.win
        grad = grad.contiguous()
        if ctx.gather is not None:
            grad = C.mesh_all_gather(grad, "batch", axis=0,
                                     rules=ctx.gather[0]).contiguous()
        if ctx.meta is not None:
            d_table = _bag_grad_shape(grad, ctx.meta, indices, offsets,
                                      ctx.mode)
        else:
            d_table = embedding_bag_backward(grad, indices, offsets,
                                             ctx.mode, R, ctx.dtype,
                                             row_lo=lo, row_hi=hi)
        return d_table, None, None, None, None, None, None


class _AsDTensor(torch.autograd.Function):
    """``DTensor.from_local`` whose backward lays the incoming gradient
    out as the forward's placements with ``collectives.local_as`` (staged
    through the host over gloo), where ``from_local``'s own backward
    would run a ``DTensor`` collective: an op's strategy may hand the
    bags' gradient back sharded over the rows' dims."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape):
        from torch.distributed.tensor import DTensor
        ctx.placements = placements
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=shape,
                                  stride=(shape[1], 1))

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.dist import collectives as C
        return C.local_as(grad, ctx.placements), None, None, None


def _sharded_bag(table, indices, offsets, mode):
    """The row-sharded (or replicated) ``DTensor`` table's route; see the
    module docstring."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import shard_block
    mesh, pl = table.device_mesh, tuple(table.placements)
    if any(not (p.is_replicate() or (p.is_shard() and p.dim == 0))
           for p in pl):
        raise ValueError(f"embedding_bag: a DTensor table must be "
                         f"replicated or sharded by rows (Shard(0)), got "
                         f"{pl}; a column-sharded table is not gathered "
                         f"here")
    R, D = table.shape
    rows_dims = [d for d, p in enumerate(pl) if p.is_shard()]
    lo, hi = shard_block(R, mesh, rows_dims)
    if hi - lo != table.to_local().shape[0]:
        raise ValueError(f"embedding_bag: rank block of "
                         f"{table.to_local().shape[0]} rows, expected rows "
                         f"[{lo}, {hi})")
    B = offsets.shape[0] - 1
    out_pl = [Replicate()] * mesh.ndim
    gather, gather_free = None, ()
    if isinstance(indices, DTensor):
        ipl = tuple(indices.placements)
        if any(not (p.is_replicate() or (p.is_shard() and p.dim == 0))
               for p in ipl):
            raise ValueError(f"embedding_bag: sharded indices must be split "
                             f"by position (Shard(0)), got {ipl}")
        N = indices.shape[0]
        idx_dims = [d for d, p in enumerate(ipl) if p.is_shard()]
        for d in idx_dims:
            out_pl[d] = Shard(0)
        split = [d for d in idx_dims if mesh.size(d) > 1]
        g_dims = [d for d in split if d in rows_dims]
        l_dims = [d for d in split if d not in rows_dims]
        if g_dims and l_dims and max(l_dims) > min(g_dims):
            raise NotImplementedError(
                f"embedding_bag: indices split over mesh dims {split} with "
                f"the rows over {rows_dims}: the dims to gather must be "
                f"inner to the others")
        n_l = n_g = 1
        for d in l_dims:
            n_l *= mesh.size(d)
        for d in g_dims:
            n_g *= mesh.size(d)
        if N % (n_l * n_g) or B % (n_l * n_g):
            raise ValueError(f"embedding_bag: {N} indices in {B} bags do "
                             f"not split evenly over {n_l * n_g} ranks")
        indices = indices.to_local()
        if g_dims:
            g_rules = C.dims_rules(mesh, "batch", g_dims)
            indices = C.mesh_all_gather(indices, "batch", axis=0,
                                        rules=g_rules)
            # this rank's bags among the gathered ones: its block over the
            # gathered dims, row-major in mesh order (the gather's order)
            g_lo, _ = shard_block(n_g, mesh, g_dims)
            gather = (g_rules, g_lo, n_g)
        gather_free = tuple(l_dims)
        if l_dims:
            p0, p1 = shard_block(N, mesh, l_dims)
            b0, b1 = shard_block(B, mesh, l_dims)
            ends = offsets[[b0, b1]].long()
            if ends.device.type != "meta" and (
                    int(ends[0]) != p0 or int(ends[1]) != p1):
                raise ValueError(f"embedding_bag: bags [{b0}, {b1}) do not "
                                 f"lie in this rank's indices [{p0}, {p1})")
            offsets = offsets[b0:b1 + 1] - p0
    indices, offsets = indices.contiguous(), offsets.contiguous()
    # a rank that bags its own part of the batch (split over dims the rows
    # are not) holds a partial gradient of its rows there
    local = table.to_local(grad_placements=[
        Partial() if gather_free and d in gather_free else p
        for d, p in enumerate(pl)])
    rows = C.dims_rules(mesh, "rows", rows_dims)
    bags = _BagFunction.apply(local, indices, offsets, mode, (lo, hi, R),
                              rows, gather)
    return _AsDTensor.apply(bags, mesh, tuple(out_pl), (B, D))


def embedding_bag(table, indices, offsets, mode: str = "sum"):
    """CSR bags of ``table`` rows (int32 ``indices``, int32[B+1]
    ``offsets``; ids clipped into the table): fp32 [B, D] sums, or means
    with ``mode="mean"``; differentiable in ``table``.  A ``DTensor``
    table (replicated or sharded by rows) takes the sharded route of the
    module docstring and returns a ``DTensor``."""
    if _is_dtensor(table):
        return _sharded_bag(table, indices, offsets, mode)
    if table.device.type == "meta":
        return _bag_shape(table, indices, offsets, mode)
    if _on_cuda("embedding_bag", table):
        indices, offsets = indices.contiguous(), offsets.contiguous()
        if table.requires_grad and torch.is_grad_enabled():
            R = table.shape[0]
            return _BagFunction.apply(table, indices, offsets, mode,
                                      (0, R, R), None, None)
        return _eb.embedding_bag(table, indices, offsets, mode)
    return ref.embedding_bag_ref(table, indices, offsets, mode)


def embedding_bag_backward(grad_out, indices, offsets, mode: str,
                           num_rows: int, dtype, *, row_lo: int = 0,
                           row_hi=None):
    """The table's gradient of :func:`embedding_bag` (``[num_rows, D]``
    in ``dtype``; rows ``[row_lo, row_hi)`` alone for a window) for
    ``grad_out`` fp32 [B, D]; the kernel on CUDA, the plain version on
    the CPU."""
    if _on_cuda("embedding_bag_backward", grad_out):
        return _eb.embedding_bag_backward(
            grad_out.contiguous(), indices.contiguous(),
            offsets.contiguous(), mode, num_rows, dtype, row_lo=row_lo,
            row_hi=row_hi)
    return ref.embedding_bag_backward_ref(grad_out, indices, offsets, mode,
                                          num_rows, dtype, row_lo=row_lo,
                                          row_hi=row_hi)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["intersect_mask", "segment_intersect_mask",
           "segment_intersect_mask_batched", "scored_intersect_batched",
           "bulk_append", "paged_attention", "embedding_bag",
           "embedding_bag_backward", "ref",
           "launch_counts", "reset_launch_counts", "KERNELS"]
