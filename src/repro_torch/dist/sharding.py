"""Logical-axis sharding rules over a ``torch.distributed`` device mesh
(the reference's ``dist/sharding.py``).

Model code never names mesh axes.  It annotates activations with
LOGICAL axis names -- ``constrain(x, "batch", None, "model", None)`` --
and parameter trees with logical spec tuples -- ``("fsdp", "model")``.
A :class:`Rules` object owns the translation: a table mapping each
logical name to a mesh dim name (a string), a tuple of names (the
dimension is sharded over several mesh dims jointly, e.g. ``batch ->
("pod", "data")``), or ``None`` (replicated).

The same model source serves every parallelism scheme: data parallel,
FSDP, tensor, expert and sequence parallel differ only in the table
(``repro_torch.launch.dryrun.rules_for``).  :func:`use_rules` installs a
table; inside it every ``constrain`` call redistributes a ``DTensor``
to the placements its logical axes resolve to, and :func:`tree_shardings`
turns a tree of spec tuples into a tree of placements for
``distribute_tensor``.  Outside any table, on a mesh of one device, or on
a plain tensor, ``constrain`` returns its input itself, so the
single-device semantics are unchanged bit for bit.

Well-known logical names (tables may add more):

  batch    data-parallel batch dim            -> ("pod", "data") / ("data",)
  fsdp     parameter-shard dim (ZeRO-3)       -> data dims when FSDP is on
  model    tensor-parallel dim (heads/ffn/vocab/experts) -> "model"
  kv_seq   decode KV-cache sequence dim       -> "model"
  seq      activation sequence dim            -> "model" when SP is on
  expert   MoE expert dim                     -> "model"
  edges    GNN edge stream                    -> data dims
  rows     recsys embedding-table rows        -> "model" (+ data when huge)
  docs     document-partitioned index shards  -> data dims
  shard    alias for ``docs``

Resolution: a name absent from the table replicates; a mesh dim shards
at most one tensor dim per spec, so a later duplicate within one spec is
dropped (the first dimension wins).  :meth:`Rules.spec` returns the
reference's ``PartitionSpec`` entries as a plain tuple (``None``, a dim
name, or a tuple of names); :meth:`Rules.placements` the ``DTensor``
placements, one per mesh dim: a tensor dim sharded over several mesh dims
gets ``Shard(i)`` on each of them, in the table's order.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Mapping, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

AxisEntry = Union[None, str, Tuple[str, ...]]
LogicalSpec = Optional[Tuple[Optional[str], ...]]

_ACTIVE: contextvars.ContextVar[Optional["Rules"]] = contextvars.ContextVar(
    "repro_torch_dist_rules", default=None)


def _as_tuple(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's dim names: a ``DeviceMesh``'s ``mesh_dim_names``, or
    ``axis_names`` of a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names")
    return tuple(names)


def mesh_shape(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` or a stand-in with a
    ``shape`` dict."""
    names = mesh_axis_names(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n


@dataclasses.dataclass(frozen=True)
class Rules:
    """A logical-name -> mesh-dims table bound to a mesh."""

    mesh: Any
    table: Mapping[str, AxisEntry]

    def __post_init__(self):
        axis_names = set(mesh_axis_names(self.mesh))
        for name, entry in self.table.items():
            for ax in _as_tuple(entry):
                if ax not in axis_names:
                    raise ValueError(
                        f"rule {name!r} -> {entry!r} names mesh axis "
                        f"{ax!r}, not in mesh axes "
                        f"{mesh_axis_names(self.mesh)}")

    def axes(self, name: Optional[str]) -> Tuple[str, ...]:
        """Mesh dims for one logical name (() when replicated/unknown)."""
        if name is None:
            return ()
        return _as_tuple(self.table.get(name))

    def spec(self, logical: LogicalSpec) -> tuple:
        """The reference's PartitionSpec entries for a logical spec tuple
        (``None`` -> ``()``, replicated), dropping mesh dims already
        consumed by an earlier dimension of the same spec."""
        if logical is None:
            return ()
        used: set = set()
        dims = []
        for name in logical:
            axes = tuple(a for a in self.axes(name) if a not in used)
            used.update(axes)
            if not axes:
                dims.append(None)
            elif len(axes) == 1:
                dims.append(axes[0])
            else:
                dims.append(axes)
        return tuple(dims)

    def placements(self, logical: LogicalSpec) -> tuple:
        """``DTensor`` placements, one per mesh dim, for a logical spec."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_axis_names(self.mesh)
        out = [Replicate() for _ in names]
        for i, entry in enumerate(self.spec(logical)):
            for ax in _as_tuple(entry):
                out[names.index(ax)] = Shard(i)
        return tuple(out)


def default_rules(mesh, *, fsdp: bool = False,
                  seq_sharded: bool = False) -> Rules:
    """The standard table for a ("pod",)? + "data" + "model" mesh.

    ``fsdp`` turns on ZeRO-3 parameter sharding over the data dims;
    ``seq_sharded`` turns on Megatron sequence parallelism over 'model'.
    """
    names = mesh_axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else None
    return Rules(mesh=mesh, table={
        "batch": dp or None,
        "fsdp": (dp or None) if fsdp else None,
        "model": model,
        "kv_seq": model,
        "seq": model if seq_sharded else None,
        "expert": model,
        "edges": dp or None,
        "rows": model,
        "docs": dp or None,
        "shard": dp or None,
    })


def current_rules() -> Optional[Rules]:
    return _ACTIVE.get()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Install ``rules`` as the ambient table for ``constrain`` calls."""
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements its logical axes resolve to.

    One logical name (or None) per dimension.  Returns ``x`` itself when
    no rules are active, on a mesh of one device, or when ``x`` is not a
    ``DTensor``, so model code calls this unconditionally."""
    if x.dim() != len(logical):
        # checked BEFORE the no-rules early return so wrong-rank
        # annotations fail in single-device unit tests, not first on a mesh
        raise ValueError(
            f"constrain got {len(logical)} logical axes for rank-{x.dim()} "
            f"tensor: {logical}")
    rules = _ACTIVE.get()
    if rules is None or mesh_size(rules.mesh) == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = rules.placements(tuple(logical))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def shard_block(n: int, mesh, dims) -> Tuple[int, int]:
    """``(lo, hi)``: this rank's block of a tensor dim of ``n`` split by
    ``Shard`` over the mesh dims ``dims`` (indices, in mesh order), as
    ``DTensor`` splits it: ``torch.chunk`` over each dim in turn."""
    coord = mesh.get_coordinate()
    lo = 0
    for d in dims:
        s, c = mesh.size(d), coord[d]
        full = -(-n // s)
        start = min(c * full, n)
        n = max(0, min(full, n - start))
        lo += start
    return lo, lo + n


def local_block(n: int, mesh, placements, dim: int = 0) -> Tuple[int, int]:
    """``(lo, hi)`` of tensor dim ``dim`` (of ``n``) that this rank holds
    under ``placements`` -- a rank's rows of a table sharded by rows."""
    return shard_block(n, mesh, [d for d, p in enumerate(placements)
                                 if p.is_shard() and p.dim == dim])


def is_spec_leaf(s: Any) -> bool:
    """Plain tuples are logical specs; NamedTuples (DecodeCache,
    optimizer states) are containers and stay traversable."""
    return s is None or (isinstance(s, tuple) and not hasattr(s, "_fields"))


def tree_shardings(rules: Rules, specs: Any) -> Any:
    """A tree of spec tuples -> the same tree of placement tuples
    (``None`` leaves replicate)."""
    return _map_specs(rules.placements, specs)


def _map_specs(fn, specs: Any) -> Any:
    """``fn`` over every spec leaf of a tree of dicts, lists and
    NamedTuples, keeping its structure."""
    if is_spec_leaf(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple):                       # a NamedTuple
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    return [_map_specs(fn, v) for v in specs]


def distribute_tree(values: Any, mesh, placements: Any, distribute=None):
    """Lay out a tree of tensors (dicts, lists, NamedTuples; ``None``
    leaves stay ``None``) on ``mesh``, each leaf with the placement tuple
    at its place in ``placements`` (a same-shaped tree, e.g. from
    :func:`tree_shardings`).  ``distribute(t, mesh, placements)`` makes
    each ``DTensor`` (default ``distribute_tensor``)."""
    if distribute is None:
        from torch.distributed.tensor import distribute_tensor as distribute
    if isinstance(values, dict):
        return {k: distribute_tree(v, mesh, placements[k], distribute)
                for k, v in values.items()}
    if isinstance(values, tuple) and hasattr(values, "_fields"):
        return type(values)(*(distribute_tree(v, mesh, p, distribute)
                              for v, p in zip(values, placements)))
    if isinstance(values, list):
        return [distribute_tree(v, mesh, p, distribute)
                for v, p in zip(values, placements)]
    if values is None:
        return None
    return distribute(values, mesh, placements)


# DTensor's words (torch 2.11 and 2.13) for an op it refuses to run on
# its inputs' placements
RESHARD_ERRORS = ("Please redistribute", "unevenly sharded",
                  "without redistribution", "requires redistribution",
                  "in-place operations that require placement changes")


def refused_for_placements(err: Exception) -> bool:
    """Whether ``DTensor`` refused an op for its inputs' placements."""
    return isinstance(err, RuntimeError) and any(
        k in str(err) for k in RESHARD_ERRORS)


def call_resharded(func, args, kwargs, err, *, inplace_on_copy=False):
    """Run a ``DTensor`` op that ``DTensor`` refused for its placements (a
    view splitting a sharded dim unevenly, say 4 kv heads over 16 ranks):
    replicate its inputs' sharded or partial mesh dims one at a time,
    first argument first, until it runs -- the resharding GSPMD inserts
    for such an op; values are unchanged.  An in-place op cannot run on a
    redistributed copy of its target and re-raises ``err``, unless
    ``inplace_on_copy`` (the dry-run on ``meta``, where only shapes flow):
    then it writes the copy and returns its target as it was."""
    from torch.distributed.tensor import DTensor, Replicate
    mutable = func._schema.is_mutable
    if mutable and not inplace_on_copy:
        raise err
    target = args[0]
    args = list(args)
    for i, a in enumerate(list(args)):
        if not isinstance(a, DTensor):
            continue
        for m, p in enumerate(a.placements):
            if p.is_replicate():
                continue
            pl = list(args[i].placements)
            pl[m] = Replicate()
            args[i] = args[i].redistribute(a.device_mesh, pl)
            try:
                out = func(*args, **kwargs)
            except RuntimeError as e:
                if not refused_for_placements(e):
                    raise
                continue
            return target if mutable else out
    raise err


class Resharding(TorchDispatchMode):
    """Runs every ``DTensor`` op that ``DTensor`` refuses for its
    placements through :func:`call_resharded` (values unchanged)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if not refused_for_placements(e):
                raise
            return call_resharded(func, args, kwargs, e)
