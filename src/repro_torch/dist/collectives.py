"""A mesh of shards stacked on one device, and its collectives.

The reference runs each document shard on its own (possibly emulated)
device inside ``shard_map``.  Here every shard lives in one process on
one device, as row ``s`` of a leading ``[S, ...]`` axis, so the
collectives are plain tensor ops on that axis: ``all_gather`` is a
concatenation and ``psum`` a sum.  Results are the same bits as the
reference's collectives over the same shard values.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``num_shards`` document shards stacked on ``device``."""

    num_shards: int
    device: torch.device


def all_gather(x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
    """Concatenate the shards of a stacked ``x[S, ...]`` along the
    per-shard ``axis`` (shard-major), as a tiled all-gather does."""
    return x.movedim(0, axis).flatten(axis, axis + 1)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum a stacked ``x[S, ...]`` over its shards."""
    return x.sum(0, dtype=x.dtype)
