"""Gradient compression: int8 quantisation with error feedback (the
reference's ``train/compression.py``).

Two forms:
  * :class:`CompressedAdamW` — an optimizer wrapper that quantises the
    gradient before the update and carries the quantisation residual into
    the next step (error feedback).
  * :func:`compressed_psum` — the comm-layer variant: int8 payloads (and
    an fp32 scale) of every shard summed over the stacked shard axis of
    :mod:`repro_torch.dist.collectives`, where the reference runs
    ``psum`` and ``pmax`` inside ``shard_map``.

``torch.round`` rounds half to even as ``jnp.round`` does, so ``q`` and
``scale`` are the reference's bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.dist import collectives
from repro_torch.train import tree as T
from repro_torch.train.optimizer import AdamW, AdamWState


def quantize_int8(x):
    """``(q int8, scale fp32 [])``: ``scale = max(max |x|, 1e-12) / 127``
    and ``q = clip(round(x / scale), -127, 127)``."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


class CompressedState(NamedTuple):
    inner: AdamWState
    residual: dict      # error-feedback buffers (fp32 per leaf)


@dataclasses.dataclass(frozen=True)
class CompressedAdamW:
    """AdamW over int8-compressed gradients with error feedback."""
    inner: AdamW

    def init(self, params) -> CompressedState:
        return CompressedState(
            inner=self.inner.init(params),
            residual=T.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params))

    def update(self, grads, state: CompressedState, params):
        sent, res = [], []
        for g, r in zip(T.leaves(grads), T.leaves(state.residual)):
            g = g.to(torch.float32) + r            # add back the residual
            dq = dequantize_int8(*quantize_int8(g))
            sent.append(dq)
            res.append(g - dq)                     # the new residual
        params, inner = self.inner.update(T.unflatten(grads, sent),
                                          state.inner, params)
        return params, CompressedState(
            inner=inner, residual=T.unflatten(state.residual, res))


def compressed_psum(tree):
    """int8 all-reduce of every stacked ``[S, ...]`` leaf: each shard
    quantised alone, the int8 payloads summed in int32, dequantised by
    the largest shard scale (conservative); ``[...]`` like
    :func:`collectives.psum`."""
    def one(x):
        x = x.to(torch.float32)
        qs = [quantize_int8(x[s]) for s in range(x.shape[0])]
        acc = collectives.psum(torch.stack([q.to(torch.int32)
                                            for q, _ in qs]))
        s = collectives.pmax(torch.stack([sc for _, sc in qs]))
        return acc.to(torch.float32) * s

    return T.tree_map(one, tree)
