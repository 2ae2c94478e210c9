"""Collectives, in two families kept apart by name, and the worlds they
run in (the reference's ``dist/collectives.py``).

**Stacked shards on one device** (:class:`Mesh`, ``all_gather``,
``psum``, ``pmean``, ``pmax``, ``all_to_all``).  The reference runs each
document shard on its own (possibly emulated) device inside
``shard_map``.  Here every shard lives in one process on one device, as
row ``s`` of a leading ``[S, ...]`` axis, so the collectives are plain
tensor ops on that axis: ``all_gather`` is a concatenation, ``psum`` a
sum, ``pmean`` the sum over S, ``pmax`` a max and ``all_to_all`` a
transpose of chunks.  Results are the same bits as the reference's
collectives over the same shard values.

**Over a process group** (``axis_size``, ``mesh_psum``, ``mesh_pmean``,
``mesh_pmax``, ``mesh_all_gather``, ``mesh_all_to_all``).  Each takes a
LOGICAL axis name, resolves it through the active (or given)
``sharding.Rules`` to mesh dims of a ``DeviceMesh``, and runs
``torch.distributed._functional_collectives`` over those dims on this
rank's local tensor -- the counterpart of the reference's ``lax``
collectives inside ``shard_map``.  An unmapped name is an exact no-op
(the tensor itself comes back).

**Worlds.**  :func:`fake_world` is a world of ``n`` ranks that moves no
data (``torch.distributed``'s fake backend): the counterpart of the
reference's ``force_host_device_count`` for the dry-run, which traces
on ``meta`` tensors.  :func:`require_devices` fails fast when the world
is smaller than asked, and :func:`host_mesh` builds a ``DeviceMesh``
over the current world.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.dist import sharding as _sh


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


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max of a stacked ``x[S, ...]`` over its shards."""
    return x.amax(0)


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean of a stacked ``x[S, ...]`` over its shards: the sum over S
    divided by S (``lax.pmean``'s psum-then-divide)."""
    return x.sum(0, dtype=x.dtype) / x.shape[0]


def all_to_all(x: torch.Tensor, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """A tiled all-to-all of a stacked ``x[S, ...]``: shard ``i`` cuts its
    ``split_axis`` into S chunks and sends chunk ``j`` to shard ``j``,
    which concatenates what it receives along ``concat_axis`` in source
    order (both axes index a shard's own dims)."""
    S = x.shape[0]
    y = x.unflatten(split_axis + 1, (S, -1))   # [src, ..., dst, n/S, ...]
    y = y.movedim(split_axis + 1, 0)           # [dst, src, ...]
    y = y.movedim(1, concat_axis + 1)          # [dst, ..., src, d_c, ...]
    return y.flatten(concat_axis + 1, concat_axis + 2)


# ---------------------------------------------------------------------------
# Worlds: fake ranks for the dry-run, checks, meshes
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks (this process is rank 0)
    on ``torch.distributed``'s fake backend: collectives return at once
    and move nothing.  The group is destroyed on exit, so nothing else in
    the process sees it."""
    import torch.distributed as dist
    # the fake backend registers itself when its module is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield n
    finally:
        dist.destroy_process_group()


def require_devices(n: int) -> None:
    """Fail fast (with the fix spelled out) when the world -- the default
    group's ranks, else the CUDA devices -- is smaller."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        have = dist.get_world_size()
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have}; run inside repro_torch.dist."
            f"collectives.fake_world({n}) for a dry-run, or start a world "
            f"of {n} ranks with torch.distributed.init_process_group")


def host_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    world (``cuda`` when the default group is NCCL, else ``cpu``)."""
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed as dist
    n = 1
    for s in shape:
        n *= s
    require_devices(n)
    if device_type is None:
        device_type = ("cuda" if dist.is_initialized()
                       and dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


# ---------------------------------------------------------------------------
# Logical-axis collectives over a DeviceMesh (on this rank's local tensor)
# ---------------------------------------------------------------------------
def _resolve(logical: str, rules: Optional[_sh.Rules]
             ) -> Tuple[Optional[_sh.Rules], Tuple[str, ...]]:
    rules = rules or _sh.current_rules()
    if rules is None:
        return None, ()
    return rules, rules.axes(logical)


def _groups(rules: _sh.Rules, axes: Tuple[str, ...]):
    """One ``(mesh, dim)`` group per mesh dim, innermost first."""
    names = _sh.mesh_axis_names(rules.mesh)
    return [(rules.mesh, names.index(a)) for a in reversed(axes)]


def _wait(t):
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(t) if isinstance(
        t, funcol.AsyncCollectiveTensor) else t


def axis_size(logical: str, rules: Optional[_sh.Rules] = None) -> int:
    """Total ways the logical axis is split (1 when unmapped)."""
    rules, axes = _resolve(logical, rules)
    n = 1
    for ax in axes:
        n *= _sh.mesh_shape(rules.mesh)[ax]
    return n


def _reduce(x, op: str, logical: str, rules):
    from torch.distributed import _functional_collectives as funcol
    rules, axes = _resolve(logical, rules)
    for group in _groups(rules, axes) if axes else ():
        x = _wait(funcol.all_reduce(x, op, group))
    return x


def mesh_psum(x, logical: str, rules: Optional[_sh.Rules] = None):
    """Sum over the ranks of the logical axis."""
    return _reduce(x, "sum", logical, rules)


def mesh_pmean(x, logical: str, rules: Optional[_sh.Rules] = None):
    """Mean over the ranks of the logical axis (sum, then divide)."""
    n = axis_size(logical, rules)
    return x if n == 1 else _reduce(x, "sum", logical, rules) / n


def mesh_pmax(x, logical: str, rules: Optional[_sh.Rules] = None):
    """Elementwise max over the ranks of the logical axis."""
    return _reduce(x, "max", logical, rules)


def mesh_all_gather(x, logical: str, *, axis: int = 0,
                    rules: Optional[_sh.Rules] = None):
    """Concatenate the ranks' tensors along ``axis`` in rank order (the
    outer mesh dim major; identity when unmapped)."""
    from torch.distributed import _functional_collectives as funcol
    rules, axes = _resolve(logical, rules)
    for group in _groups(rules, axes) if axes else ():
        x = _wait(funcol.all_gather_tensor(x.contiguous(), axis, group))
    return x


def mesh_all_to_all(x, logical: str, *, split_axis: int, concat_axis: int,
                    rules: Optional[_sh.Rules] = None):
    """Tiled all-to-all over the logical axis (the expert-parallel
    dispatch primitive; identity when unmapped): ``split_axis`` is cut
    into one chunk per rank, chunk ``j`` goes to rank ``j``, and the
    received chunks concatenate along ``concat_axis`` in rank order.  The
    axis must map to one mesh dim."""
    from torch.distributed import _functional_collectives as funcol
    rules, axes = _resolve(logical, rules)
    if not axes:
        return x
    if len(axes) > 1:
        raise ValueError(f"mesh_all_to_all over {axes}: one mesh dim only")
    (group,) = _groups(rules, axes)
    g = axis_size(logical, rules)
    y = x.movedim(split_axis, 0).contiguous()
    y = _wait(funcol.all_to_all_single(y, None, None, group))
    y = y.unflatten(0, (g, -1)).movedim(1, split_axis + 1)
    return y.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)
