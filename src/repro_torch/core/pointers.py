"""Packed 32-bit slice pointers (paper §3.2), in torch.

A pointer addresses a slot inside a slice inside a pool:

    [ pool_bits | slice_bits(p) | offset_bits(p) ]   (MSB -> LSB)

where ``offset_bits(p) == z_p`` (slice size ``2**z_p``) and
``slice_bits(p) = 32 - pool_bits - z_p``.  ``NULL == 0xFFFF_FFFF`` is
reserved (the all-ones slice of the last pool is never allocated).

Torch lacks shifts, comparisons and gathers on ``uint32``, so every
pointer is carried as an int64 holding its uint32 value; arithmetic that
wraps mod 2**32 in the reference is masked with ``U32`` here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

NULL = 0xFFFFFFFF
U32 = 0xFFFFFFFF
PTR_BITS = 32


def _ceil_log2(x: int) -> int:
    return max(1, int(math.ceil(math.log2(max(x, 2)))))


@dataclasses.dataclass(frozen=True)
class PoolLayout:
    """Static description of a pool configuration ``Z``.

    Attributes:
      z: slice-size exponents ``(z_0, ..., z_{P-1})`` — paper's ``Z``.
      slices_per_pool: capacity of each pool, in slices.
    """

    z: Tuple[int, ...]
    slices_per_pool: Tuple[int, ...]

    @property
    def num_pools(self) -> int:
        return len(self.z)

    @property
    def pool_bits(self) -> int:
        return _ceil_log2(self.num_pools)

    @property
    def slice_sizes(self) -> Tuple[int, ...]:
        return tuple(1 << zp for zp in self.z)

    @property
    def slice_bits(self) -> Tuple[int, ...]:
        return tuple(PTR_BITS - self.pool_bits - zp for zp in self.z)

    def max_slices(self, p: int) -> int:
        # all-ones slice index in the last pool is reserved so that NULL
        # can never collide with a real pointer.
        cap = 1 << self.slice_bits[p]
        return cap - 1 if p == self.num_pools - 1 else cap

    @property
    def pool_slots(self) -> Tuple[int, ...]:
        return tuple(
            n * s for n, s in zip(self.slices_per_pool, self.slice_sizes)
        )

    @property
    def pool_base(self) -> Tuple[int, ...]:
        bases, acc = [], 0
        for slots in self.pool_slots:
            bases.append(acc)
            acc += slots
        return tuple(bases)

    @property
    def total_slots(self) -> int:
        return sum(self.pool_slots)

    @property
    def total_slices(self) -> int:
        """Capacity of the flat per-pool free-list array."""
        return sum(self.slices_per_pool)

    @property
    def free_base(self) -> Tuple[int, ...]:
        """Start offset of each pool's region inside the free-list array."""
        bases, acc = [], 0
        for n in self.slices_per_pool:
            bases.append(acc)
            acc += n
        return tuple(bases)

    def __post_init__(self):
        if not self.z:
            raise ValueError("Z must be non-empty")
        if any(b <= a for a, b in zip(self.z, self.z[1:])):
            raise ValueError(f"Z must be strictly increasing, got {self.z}")
        if len(self.slices_per_pool) != len(self.z):
            raise ValueError("slices_per_pool must match Z length")
        for p, (n, zp) in enumerate(zip(self.slices_per_pool, self.z)):
            bits = PTR_BITS - self.pool_bits - zp
            if bits <= 0:
                raise ValueError(
                    f"pool {p}: z_p={zp} leaves no slice bits "
                    f"(pool_bits={self.pool_bits})"
                )
            if n > self.max_slices(p):
                raise ValueError(
                    f"pool {p}: {n} slices exceed addressable "
                    f"{self.max_slices(p)} with {bits} slice bits"
                )

    def tables(self, device) -> dict:
        """Per-pool constant int64 tables used by encode/decode."""
        def t(vals):
            return torch.tensor(vals, dtype=torch.int64, device=device)
        return dict(
            z=t(self.z),
            slice_size=t(self.slice_sizes),
            offset_mask=t([(1 << zp) - 1 for zp in self.z]),
            slice_mask=t([(1 << b) - 1 for b in self.slice_bits]),
            base=t(self.pool_base),
            free_base=t(self.free_base),
        )


# --------------------------------------------------------------------------
# Vectorised encode / decode over int64 tensors holding uint32 values.
# Pool indices are clamped to the table like the reference's clamped
# gathers; out-of-range pointers decode to garbage that callers mask.
# --------------------------------------------------------------------------
def _pool_idx(tbl, pool):
    return pool.clamp(0, tbl["z"].shape[0] - 1)


def encode(tbl, pool_bits: int, pool, slice_idx, offset):
    """Pack (pool, slice, offset) into a uint32 pointer (as int64)."""
    z = tbl["z"][_pool_idx(tbl, pool)]
    return (((pool << (PTR_BITS - pool_bits)) & U32)
            | ((slice_idx << z) & U32)
            | (offset & U32))


def decode(tbl, pool_bits: int, ptr):
    """Unpack a uint32 pointer (as int64) into (pool, slice, offset)."""
    pool = (ptr >> (PTR_BITS - pool_bits)).clamp(
        max=tbl["z"].shape[0] - 1)
    z = tbl["z"][pool]
    rest = ptr & ((1 << (PTR_BITS - pool_bits)) - 1)
    slice_idx = (rest >> z) & tbl["slice_mask"][pool]
    offset = rest & tbl["offset_mask"][pool]
    return pool, slice_idx, offset


def to_addr(tbl, pool, slice_idx, offset):
    """Flat heap address of a decoded pointer (wraps mod 2**32)."""
    p = _pool_idx(tbl, pool)
    return (tbl["base"][p] + slice_idx * tbl["slice_size"][p]
            + offset) & U32


def ptr_to_addr(tbl, pool_bits: int, ptr):
    return to_addr(tbl, *decode(tbl, pool_bits, ptr))


def is_null(ptr):
    return ptr == NULL


# Host-side convenience (Python ints) ----------------------------------------
def encode_host(layout: PoolLayout, pool: int, slice_idx: int, offset: int) -> int:
    z = layout.z[pool]
    return (pool << (PTR_BITS - layout.pool_bits)) | (slice_idx << z) | offset


def decode_host(layout: PoolLayout, ptr: int) -> Tuple[int, int, int]:
    pool = min(ptr >> (PTR_BITS - layout.pool_bits), layout.num_pools - 1)
    z = layout.z[pool]
    rest = ptr & ((1 << (PTR_BITS - layout.pool_bits)) - 1)
    return pool, rest >> z, rest & ((1 << z) - 1)


def production_layout(slices_per_pool: Sequence[int] | None = None) -> PoolLayout:
    """The paper's production config ``Z^g = <1, 4, 7, 11>``."""
    if slices_per_pool is None:
        slices_per_pool = (1 << 15, 1 << 13, 1 << 11, 1 << 9)
    return PoolLayout(z=(1, 4, 7, 11), slices_per_pool=tuple(slices_per_pool))
