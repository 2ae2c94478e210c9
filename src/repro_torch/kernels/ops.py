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

A ``meta`` table (the dry-run, ``launch/dryrun.py``) takes a shape-only
route: two custom ops, ``repro_torch::bag_shape`` and its gradient
``repro_torch::bag_grad_shape``, whose fake implementations give the
output's shape and dtype and whose real ones raise, so no device ever
runs them.  :func:`register_meta_sharding` gives them ``DTensor``
sharding rules (a table replicated, or sharded by rows with the bags'
partial sums reduced after), which only these meta ops carry: a sharded
table on a real device still reaches the kernel's wrapper, which takes
plain tensors.
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


def register_meta_sharding() -> None:
    """``DTensor`` rules of the shape-only bag ops (idempotent): the
    indices and offsets replicated; the table replicated (the bags
    replicated), or sharded by rows (each rank sums its own rows: the
    bags are partial sums, and the table's gradient is sharded as the
    table is)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    @register_sharding(torch.ops.repro_torch.bag_shape.default)
    def _bag_rule(table, indices, offsets, mode):
        return [([R], [R, R, R, None]),
                ([Partial()], [Shard(0), R, R, None])]

    @register_sharding(torch.ops.repro_torch.bag_grad_shape.default)
    def _bag_grad_rule(grad, table, indices, offsets, mode):
        return [([R], [R, R, R, R, None]),
                ([Shard(0)], [R, Shard(0), R, R, None])]


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
    """The CUDA bag with its table's gradient: forward
    ``embedding_bag``, backward ``embedding_bag_backward`` (both
    kernels; the indices and offsets get no gradient)."""

    @staticmethod
    def forward(ctx, table, indices, offsets, mode):
        ctx.save_for_backward(indices, offsets)
        ctx.mode, ctx.rows, ctx.dtype = mode, table.shape[0], table.dtype
        return _eb.embedding_bag(table, indices, offsets, mode)

    @staticmethod
    def backward(ctx, grad):
        indices, offsets = ctx.saved_tensors
        d_table = _eb.embedding_bag_backward(
            grad.contiguous(), indices, offsets, ctx.mode, ctx.rows,
            ctx.dtype)
        return d_table, None, None, None


def embedding_bag(table, indices, offsets, mode: str = "sum"):
    """CSR bags of ``table`` rows (int32 ``indices``, int32[B+1]
    ``offsets``; ids clipped into the table): fp32 [B, D] sums, or means
    with ``mode="mean"``; differentiable in ``table``."""
    if table.device.type == "meta":
        return _bag_shape(table, indices, offsets, mode)
    if _on_cuda("embedding_bag", table):
        indices, offsets = indices.contiguous(), offsets.contiguous()
        if table.requires_grad and torch.is_grad_enabled():
            return _BagFunction.apply(table, indices, offsets, mode)
        return _eb.embedding_bag(table, indices, offsets, mode)
    return ref.embedding_bag_ref(table, indices, offsets, mode)


def embedding_bag_backward(grad_out, indices, offsets, mode: str,
                           num_rows: int, dtype):
    """The table's gradient of :func:`embedding_bag` (``[num_rows, D]``
    in ``dtype``) for ``grad_out`` fp32 [B, D]; the kernel on CUDA, the
    plain version on the CPU."""
    if _on_cuda("embedding_bag_backward", grad_out):
        return _eb.embedding_bag_backward(
            grad_out.contiguous(), indices.contiguous(),
            offsets.contiguous(), mode, num_rows, dtype)
    return ref.embedding_bag_backward_ref(grad_out, indices, offsets, mode,
                                          num_rows, dtype)


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
