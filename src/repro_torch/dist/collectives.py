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
(the tensor itself comes back).  :func:`dims_rules` names a tensor's own
mesh dims for them, and :func:`placement_psum` sums over the dims a
``DTensor``'s placements shard (the global-norm clip of a sharded
gradient), and :func:`local_as` lays a ``DTensor``'s local tensor out
anew (a gradient that arrives with other placements): the ``DTensor``
reductions of a sharded step, done on local tensors by this family
instead of ``DTensor``'s own collectives.

A collective's result lies where its input lies; the transport is the
backend's.  Over gloo a CUDA tensor is staged through host memory by the
collective itself (copied to the CPU, reduced or gathered there, copied
back to its device): the functional collectives crash on gloo with CUDA
tensors on the card's torch 2.11.  A host tensor therefore crosses gloo
with no copy, and over NCCL it travels through the current CUDA device.
Compute stays where the caller put it; only the transport moves.

**One shard per process** (:class:`RankMesh`).  The counterpart of the
reference's ``(mesh, rules)`` for the document-sharded index: this
rank holds one shard (its id row-major over the mesh dims the logical
``docs`` axis maps to) on its own device, and the shard-axis reductions
the stacked :class:`Mesh` does on its leading axis become the
process-group collectives above.  Both meshes answer the same small
interface (``local_shards``, ``leads``, ``stack``, ``collect``,
``gather``, ``sum``, ``combine``, ``broadcast``), so the index and the
serving loop run one code path over either.

**Worlds.**  :func:`fake_world` is a world of ``n`` ranks that moves no
data (``torch.distributed``'s fake backend): the counterpart of the
reference's ``force_host_device_count`` for the dry-run, which traces
on ``meta`` tensors.  :func:`process_world` starts and destroys a real
world (from torchrun's environment, or from an explicit rank, size and
port) over the backend the caller names.  :func:`require_devices`
fails fast when the world is smaller than asked, and :func:`host_mesh`
builds a ``DeviceMesh`` over the current world.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.dist import sharding as _sh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``num_shards`` document shards stacked on ``device``: every shard
    is local, and a shard-axis collective is a tensor op on the leading
    ``[S, ...]`` axis."""

    num_shards: int
    device: torch.device

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The global ids of the shards this process holds, in the order
        of its state's leading axis."""
        return tuple(range(self.num_shards))

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's row of ``x[L, ...]`` as ``[S, ...]`` in shard
        order (here ``x`` itself)."""
        return x

    def collect(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Every shard's row of ``x[L, ...]`` as ``[S, ...]`` on shard
        0's process, ``None`` on the others (here ``x`` itself)."""
        return x

    def gather(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        """:func:`all_gather` of the local stack ``x[L, ...]``."""
        return all_gather(x, axis=axis)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`psum` of the local stack ``x[L, ...]``."""
        return psum(x)

    @property
    def leads(self) -> bool:
        """Whether this process holds shard 0 (here: always)."""
        return True

    def combine(self, value, op: str = "sum"):
        """A host number already reduced over the local shards, reduced
        over every process (here: the value itself)."""
        return value

    def broadcast(self, obj=None):
        """Shard 0's process's host object on every process (here: the
        object itself)."""
        return obj


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


@contextlib.contextmanager
def process_world(backend: str, *, rank: Optional[int] = None,
                  world_size: Optional[int] = None,
                  port: Optional[int] = None, host: str = "localhost",
                  timeout_s: Optional[float] = None):
    """A default process group over ``backend`` for the body of the
    ``with``, destroyed on exit; yields ``(rank, world_size)``.

    The caller names the backend: ``"nccl"`` for one rank a card,
    ``"gloo"`` for CPU ranks or for several ranks sharing one card (NCCL
    refuses two ranks of one communicator on one GPU).  With ``rank``,
    ``world_size`` and ``port`` the ranks meet at ``tcp://host:port``;
    with none of them the world comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).
    ``timeout_s`` bounds every collective, so a rank left waiting for a
    dead peer raises instead of hanging."""
    import datetime
    import torch.distributed as dist
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"process_world: backend {backend!r} is neither "
                         f"'nccl' nor 'gloo'")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("process_world('nccl') needs a CUDA device; "
                           "name 'gloo' for CPU ranks")
    if dist.is_initialized():
        raise RuntimeError("process_world: a process group already exists")
    given = (rank, world_size, port)
    kw = {}
    if all(v is None for v in given):
        init = "env://"
    elif any(v is None for v in given):
        raise ValueError("process_world: give rank, world_size and port "
                         "together, or none of them (torchrun's "
                         "environment)")
    else:
        init = f"tcp://{host}:{int(port)}"
        kw = dict(rank=int(rank), world_size=int(world_size))
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend, init_method=init, **kw)
    try:
        yield dist.get_rank(), dist.get_world_size()
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


def _staged(x: torch.Tensor, backends):
    """``(x to send, device to bring the result back to)`` over groups
    of ``backends``: a CUDA tensor bound for gloo travels through host
    memory (gloo's functional collectives crash on CUDA tensors), a host
    tensor bound for NCCL through the current CUDA device; otherwise
    ``x`` itself and ``None``."""
    backends = set(backends)
    if x.is_cuda and "gloo" in backends:
        return x.cpu(), x.device
    if x.device.type == "cpu" and backends == {"nccl"}:
        return x.cuda(), x.device
    return x, None


def _backends(groups):
    import torch.distributed as dist
    return [dist.get_backend(m.get_group(d)) for m, d in groups]


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
    if not axes:
        return x
    groups = _groups(rules, axes)
    x, home = _staged(x, _backends(groups))
    for group in groups:
        x = _wait(funcol.all_reduce(x, op, group))
    return x if home is None else x.to(home)


def mesh_psum(x, logical: str, rules: Optional[_sh.Rules] = None):
    """Sum over the ranks of the logical axis."""
    return _reduce(x, "sum", logical, rules)


def dims_rules(mesh, logical: str, dims) -> _sh.Rules:
    """A table mapping ``logical`` to the mesh dims ``dims`` (indices into
    ``mesh``'s dims) that hold more than one rank: the collectives above
    over a tensor's own placements (a dim of one rank moves nothing and
    is left out; with none left the name is unmapped, a no-op)."""
    names = _sh.mesh_axis_names(mesh)
    keep = tuple(names[d] for d in sorted(set(dims)) if mesh.size(d) > 1)
    return _sh.Rules(mesh=mesh, table={logical: keep or None})


def local_as(x, placements) -> torch.Tensor:
    """The local tensor of ``DTensor`` ``x`` as ``placements`` lay it out
    on ``x``'s mesh, moved by this family and never by ``DTensor``'s own
    collectives.  Every mesh dim whose placement changes, and every dim
    that shards a tensor dim one of those shards, is first made whole (a
    ``Partial`` dim by a staged sum, a ``Shard(k)`` dim by a staged
    all-gather along k, the inner mesh dims first); then each of them
    that the target shards takes this rank's chunk (``torch.chunk``, the
    outer dims first), as ``DTensor`` splits.  A dim of one rank moves
    nothing; the shards must be even.  Used where a ``DTensor``
    collective would send a CUDA tensor over gloo (:func:`staged_for`):
    the sharded bag's backward, a sharded step's gradients."""
    mesh = x.device_mesh
    have, want = tuple(x.placements), tuple(placements)
    live = [d for d in range(mesh.ndim) if mesh.size(d) > 1]
    moved = {d for d in live if have[d] != want[d]}
    dims = {p.dim for d in moved for p in (have[d], want[d]) if p.is_shard()}
    moved |= {d for d in live if have[d].is_shard() and have[d].dim in dims}
    t = x.to_local()
    for d in sorted(moved, reverse=True):
        rules = dims_rules(mesh, "dim", [d])
        if have[d].is_partial():
            t = mesh_psum(t, "dim", rules=rules)
        elif have[d].is_shard():
            t = mesh_all_gather(t, "dim", axis=have[d].dim, rules=rules)
    coord = mesh.get_coordinate()
    for d in sorted(moved):
        if want[d].is_shard():
            t = t.chunk(mesh.size(d), dim=want[d].dim)[coord[d]]
        elif not want[d].is_replicate():
            raise NotImplementedError(f"local_as: to {want[d]} on mesh dim "
                                      f"{d}")
    return t.contiguous()


def staged_for(x) -> bool:
    """Whether ``DTensor``'s own collectives on ``x`` would send a CUDA
    tensor over gloo (ranks sharing a card), where they crash: the cases
    the staged family (:func:`local_as`) takes instead."""
    if not x.device.type == "cuda":
        return False
    mesh = x.device_mesh
    return "gloo" in _backends([(mesh, d) for d in range(mesh.ndim)])


def placement_psum(x, mesh, placements):
    """Sum over the ranks of the mesh dims on which ``placements`` shard
    a tensor (``Shard`` of any tensor dim): a local partial -- a sum of
    squares of this rank's block, say -- becomes the whole tensor's on
    every rank, staged through the host over gloo as :func:`mesh_psum`.
    Replicated dims and dims of one rank send nothing."""
    dims = [d for d, p in enumerate(placements) if p.is_shard()]
    return mesh_psum(x, "shards", rules=dims_rules(mesh, "shards", dims))


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
    if not axes:
        return x
    groups = _groups(rules, axes)
    x, home = _staged(x, _backends(groups))
    for group in groups:
        x = _wait(funcol.all_gather_tensor(x.contiguous(), axis, group))
    return x if home is None else x.to(home)


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
    y, home = _staged(x.movedim(split_axis, 0).contiguous(),
                      _backends([group]))
    y = _wait(funcol.all_to_all_single(y, None, None, group))
    y = y if home is None else y.to(home)
    y = y.unflatten(0, (g, -1)).movedim(1, split_axis + 1)
    return y.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


# ---------------------------------------------------------------------------
# One document shard per process
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's document shard of ``num_shards``: ``shard`` is its id
    (row-major over the mesh dims the logical ``docs`` axis maps to, as
    the reference's ``_shard_index``), ``device`` holds its state,
    ``rules`` maps ``docs`` onto a ``DeviceMesh`` of the world, and
    ``peers`` are the global ranks of this rank's ``docs`` group in
    shard order.  Its state keeps the stacked layout with one row
    (``[1, ...]``), and the shard-axis collectives of :class:`Mesh`
    become ``mesh_all_gather`` and ``mesh_psum``/``mesh_pmax`` over
    ``axis``: every rank of the axis must make the same calls in the
    same order.  Built by
    ``repro_torch.core.sharded_index.make_rank_mesh``."""

    num_shards: int
    shard: int
    device: torch.device
    rules: _sh.Rules
    peers: Tuple[int, ...]
    axis = "docs"      # the logical axis of the shards

    @property
    def local_shards(self) -> Tuple[int, ...]:
        return (self.shard,)

    @property
    def leads(self) -> bool:
        """Whether this rank holds shard 0 (the rank that decides for
        the ``docs`` group, as :meth:`broadcast`'s source)."""
        return self.shard == 0

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x[1, ...]`` as ``[S, ...]`` in shard order."""
        return mesh_all_gather(x, self.axis, axis=0, rules=self.rules)

    def collect(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Every rank's ``x[1, ...]`` as ``[S, ...]`` in shard order on
        shard 0's rank, ``None`` on the others: point-to-point sends to
        shard 0 over the default group, so no other rank holds the
        whole.  The result lies where ``x`` lies (gloo sends host
        tensors, NCCL device tensors)."""
        import torch.distributed as dist
        t, home = _staged(x.contiguous(), [dist.get_backend()])
        if self.shard != 0:
            dist.send(t, self.peers[0])
            return None
        parts = [t]
        for peer in self.peers[1:]:
            parts.append(torch.empty_like(t))
            dist.recv(parts[-1], peer)
        out = torch.cat(parts)
        return out if home is None else out.to(home)

    def gather(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        """The tiled all-gather of each rank's ``x[0]`` along ``axis``:
        the stacked :func:`all_gather`'s bits."""
        return mesh_all_gather(x[0], self.axis, axis=axis, rules=self.rules)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x[0]`` summed over the ranks (the stacked :func:`psum`)."""
        return mesh_psum(x[0], self.axis, rules=self.rules)

    def combine(self, value, op: str = "sum"):
        """A host number (this rank's shard's) summed (``op="sum"``) or
        maxed (``"max"``) over the ranks; int64 for ints and bools,
        float64 for floats, so every rank gets the same exact value."""
        if op not in ("sum", "max"):
            raise ValueError(f"combine: op {op!r} is neither 'sum' nor "
                             f"'max'")
        is_float = isinstance(value, float)
        t = torch.tensor([value if is_float else int(value)],
                         dtype=torch.float64 if is_float else torch.int64)
        fn = mesh_psum if op == "sum" else mesh_pmax
        out = fn(t, self.axis, rules=self.rules)[0].item()
        return float(out) if is_float else int(out)

    def broadcast(self, obj=None):
        """Shard 0's rank's host object (``obj`` there, which gets it
        back; the others pass nothing) on every rank of the ``docs``
        group: pickled to bytes, its length and then its bytes broadcast
        from coordinate 0 of each mesh dim ``docs`` maps to in turn, so
        every rank's copy comes from shard 0's.  Host tensors cross gloo
        as they are and NCCL through the current card (``_staged``).
        Every rank of the group must call it, in the same order as its
        other collectives."""
        import pickle
        if self.leads:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                    dtype=torch.uint8)
        else:
            data = torch.empty(0, dtype=torch.uint8)
        for mesh, dim in _groups(self.rules, self.rules.axes(self.axis)):
            group = mesh.get_group(dim)
            at = [int(c) for c in mesh.get_coordinate()]
            at[dim] = 0
            src = int(mesh.mesh[tuple(at)])
            n = _broadcast(torch.tensor([data.numel()]), src, group)
            if data.numel() != int(n[0]):
                data = torch.empty(int(n[0]), dtype=torch.uint8)
            data = _broadcast(data, src, group)
        return obj if self.leads else pickle.loads(data.numpy().tobytes())


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, in place
    where it lies (staged for the group's backend)."""
    import torch.distributed as dist
    t, home = _staged(x, [dist.get_backend(group)])
    dist.broadcast(t, src, group=group)
    return t if home is None else t.to(home)
