"""AdamW (the reference's ``train/optimizer.py``): global-norm clip,
decoupled weight decay, a warmup + cosine schedule, and a configurable
moment dtype (bf16 moments for the largest models).

The update is the reference's, op for op: the clip scale, the schedule
and the bias corrections ``1 - b ** step`` are fp32 tensors (a Python
float would round them differently), each leaf is updated in fp32 and
cast back to its parameter's (and its moment's) dtype.  ``update`` is
pure, like the reference's: it returns new trees and leaves its inputs
alone.  Inside it the fp32 temporaries are updated in place and freed as
soon as they are spent, which keeps one leaf's scratch at about three
fp32 copies of the leaf (Gemma3-12B's embedding is 1.0B values); every op
rounds as the reference's separate ops do (no fused multiply-add).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.train import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 []
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: Optional[str] = None   # None = same as param

    def _mdt(self, p) -> torch.dtype:
        return getattr(torch, self.moment_dtype) if self.moment_dtype \
            else p.dtype

    def init(self, params) -> AdamWState:
        """Zero moments (each laid out as its parameter: a ``DTensor``
        parameter gets a ``DTensor`` moment with its placements); ``step``
        is an int32 scalar on the parameters' device."""
        first = T.leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=T.tree_map(lambda p: torch.zeros_like(
                p, dtype=self._mdt(p), memory_format=torch.contiguous_format),
                params),
            nu=T.tree_map(lambda p: torch.zeros_like(
                p, dtype=self._mdt(p), memory_format=torch.contiguous_format),
                params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Learning rate at ``step`` (a tensor), fp32: linear warmup,
        then cosine decay to 10% of ``lr``."""
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - self.warmup_steps)
                        / max(self.total_steps - self.warmup_steps, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return self.lr * warm * (0.1 + 0.9 * cos)

    def update(self, grads, state: AdamWState, params):
        """``(new params, new state)``; ``grads`` share ``params``' tree."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            g = g * scale if scale is not None else g.clone()
            m32 = m.to(torch.float32) * b1
            m32 += g * (1 - b1)
            v32 = v.to(torch.float32) * b2
            v32 += g.square_().mul_(1 - b2)
            del g
            new_m, new_v = m32.to(m.dtype), v32.to(v.dtype)
            delta = torch.div(v32, c2).sqrt_().add_(self.eps)
            del v32                                 # sqrt(vhat) + eps
            delta = torch.div(m32, c1).div_(delta)  # mhat / (...)
            del m32
            delta += p.to(torch.float32).mul_(self.weight_decay) \
                if p.dtype != torch.float32 else p * self.weight_decay
            p32 = p.to(torch.float32, copy=True)
            p32 -= delta.mul_(lr)
            return p32.to(p.dtype), new_m, new_v

        out = [upd(p, g, m, v) for p, g, m, v in zip(
            T.leaves(params), T.leaves(grads), T.leaves(state.mu),
            T.leaves(state.nu))]
        return (T.unflatten(params, [o[0] for o in out]),
                AdamWState(step=step,
                           mu=T.unflatten(state.mu, [o[1] for o in out]),
                           nu=T.unflatten(state.nu, [o[2] for o in out])))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``jax.tree`` order) of each
    leaf's fp32 sum of squares.

    A tree of ``DTensor`` leaves (a sharded step's gradients) is summed
    on local tensors: each leaf's local sum of squares (a partial leaf
    first made whole by ``dist.collectives.local_as``), the leaves
    grouped by the mesh dims their placements shard, and each group's
    sum reduced once over those dims by
    ``dist.collectives.placement_psum`` (staged through the host over
    gloo: no ``DTensor`` collective runs).  The norm comes back as a
    replicated ``DTensor`` scalar on the leaves' mesh, equal to the
    plain tree's within fp32 rounding of the order of the sums."""
    leaves = T.leaves(tree)
    from torch.distributed.tensor import DTensor
    if not any(isinstance(g, DTensor) for g in leaves):
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
        return torch.sqrt(sum(sq[1:], sq[0]))
    from torch.distributed.tensor import Replicate
    from repro_torch.dist.collectives import local_as, placement_psum
    groups = {}                       # shard dims -> (placements, [sums])
    mesh = None
    for g in leaves:
        if not isinstance(g, DTensor):
            raise TypeError("global_norm: a tree mixes DTensor and plain "
                            "leaves")
        mesh = g.device_mesh
        pl = tuple(Replicate() if p.is_partial() else p
                   for p in g.placements)
        key = tuple(d for d, p in enumerate(pl) if p.is_shard())
        local = torch.sum(torch.square(local_as(g, pl).to(torch.float32)))
        groups.setdefault(key, (pl, []))[1].append(local)
    total = None
    for placements, sums in groups.values():
        part = placement_psum(sum(sums[1:], sums[0]), mesh, placements)
        total = part if total is None else total + part
    return DTensor.from_local(torch.sqrt(total), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)
