"""Dry-run of one (arch x shape x mesh) cell: the step traced on ``meta``
tensors over a mesh of fake ranks, its per-device FLOPs, bytes, wire
bytes and memory counted, and the three-term roofline printed as one
JSON line (the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xdeepfm \\
        --shape serve_p99 --mesh single --out ""
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8

How a cell is traced.  ``--mesh single`` is the (16, 16) data x model
mesh, ``--mesh multi`` the (2, 16, 16) pod x data x model one, both over
a world of fake ranks (``dist.collectives.fake_world``: nothing is sent,
nothing computed) -- the counterpart of the reference's 512 forced host
devices and its AOT compile.  ``--mesh card`` is the one-card mesh of
the H100 this port runs on, a real NCCL world of size 1 (it needs CUDA
and raises without it); its tensors are still ``meta``.  Parameters,
optimizer state, caches and inputs are made on ``meta`` and laid out by
``tree_shardings(rules_for(...), specs)`` as ``DTensor``s; the step then
runs under ``use_rules``, ``implicit_replication()`` (plain tensors the
models make are replicated) and the counters below.  ``DTensor`` picks
the collectives its placements need, and ``constrain`` redistributes at
the reference's annotation points.  Where ``DTensor`` refuses an op for
its placements (a view splitting a sharded dim unevenly), the refused
mesh dims are replicated first, as GSPMD reshards; where its strategy
for an op fails outright or is missing (torch 2.11's ``index``,
``index_put`` and ``index_add`` on some placements), the op runs with
its inputs replicated, and ``notes`` names each such op and its count.

How the counts are per device.  Each ``DTensor``'s local shard is a thin
wrapper tensor (:class:`_Local`), so every op a device runs on its own
shard -- after ``DTensor`` has redistributed its inputs -- reaches the
counter with the shard's shapes; ops on plain tensors (replicated, so
run whole on every device) reach it through a dispatch mode.  The
``DTensor`` layer's own bookkeeping (planning a redistribute, once per
cached plan) is no device's work and is not counted.

  flops_per_dev   matmul-family ops by ``torch.utils.flop_counter``'s
                  formulas, plus one per output element of each pointwise
                  op.
  bytes_per_dev   every op's input and output bytes (views and
                  allocations excluded): unfused, like XLA's "bytes
                  accessed" before fusion.
  wire/collectives  each functional collective's kind, output bytes and
                  group size through ``roofline.wire_bytes``.  A fake
                  mesh is ``cpu``-typed, and ``DTensor`` turns a
                  shard-to-shard move over a ``cpu`` mesh into an
                  all-gather and a chunk, so such moves count as
                  all-gathers (``notes`` says when a cell had any).
  per_device_mem  the local bytes of the step's arguments plus the peak
                  of live temporaries (outputs of non-view ops, a view
                  keeping its base alive, freed when the last reference
                  goes; what autograd saves stays live).

``t_lower_s`` and ``t_compile_s`` hold the trace's wall time (there is
no compile).  ``--set probe=True`` traces an LM at two depths and
extrapolates linearly in the layer count, as the reference does; on a
reduced config the extrapolated FLOPs, bytes, wire bytes and argument
bytes equal a full-depth trace (the peak of temporaries is a max over
the step: extrapolated, approximate).  ``--set global_batch=N
seq_len=M`` traces a cell at another batch or length (a step timed at
the shape its phase runs).  The
XLA knobs ``unroll`` (the port's layer stacks are Python loops, always
unrolled) and ``fp32`` (an XLA:CPU legalisation workaround; here the
step is traced in fp32 and the memory term halved, as the reference
records it) are accepted.

The fake process group never shares a process with anything else:
``main`` runs one cell and exits, and ``--all`` runs one subprocess per
cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          return_and_correct_aliasing)
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import registry
from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import (Rules, call_resharded,
                                       distribute_tree, mesh_axis_names,
                                       mesh_shape, mesh_size,
                                       refused_for_placements,
                                       tree_shardings, use_rules)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as T
from repro_torch.train import steps as S
from repro_torch.train.optimizer import AdamW

MESH_KINDS = ("single", "multi", "card")
CARD_NEEDS_CUDA = ("--mesh card needs CUDA: it is the one-card mesh of the "
                   "H100 this port runs on")


# ---------------------------------------------------------------------------
# Per-cell rules (logical axis -> mesh dims), honoring fit/hillclimb knobs
# ---------------------------------------------------------------------------
def rules_for(mesh, entry, spec, ov) -> Rules:
    shape = mesh_shape(mesh)
    names = mesh_axis_names(mesh)
    dp = mesh_lib.batch_axes_for(mesh, max(spec.global_batch, 1))
    full_dp = (("pod", "data") if "pod" in names else ("data",))
    cfg = entry.config
    fsdp = ov.get("fsdp")
    if fsdp is None:
        fsdp = bool(getattr(cfg, "fsdp", False))
        if entry.family == "lm" and spec.kind == "decode":
            # serving: weights TP over 'model'; add FSDP only when the
            # model-sharded weights alone would blow past HBM (grok-1).
            param_bytes = cfg.param_count * 2
            fsdp = param_bytes / shape["model"] > 8e9
    rows = ov.get("rows")
    if rows is None:
        rows = ("dp_model" if getattr(cfg, "total_rows", 0) > 5e7
                else "model")
    table = {
        "batch": dp,
        "fsdp": full_dp if fsdp else None,
        "model": "model",
        "kv_seq": "model",
        "seq": "model" if ov.get("seq_sharded") else None,
        "edges": full_dp,
        "rows": (full_dp + ("model",)) if rows == "dp_model" else ("model",),
    }
    if ov.get("scheme") == "fsdp_pure":
        # no tensor parallelism: batch and parameter shards span both
        # dims ('data', 'model'); the collectives left are the gradient
        # reduction and the FSDP weight all-gathers.
        both = ("data", "model")
        if spec.global_batch % (shape["data"] * shape["model"]) == 0:
            table["batch"] = both
        table["model"] = None
        table["fsdp"] = both
        table["kv_seq"] = None
    return Rules(mesh=mesh, table=table)


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Per-device counting
# ---------------------------------------------------------------------------
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_NO_BYTES = {"empty", "empty_like", "new_empty", "empty_strided",
             "new_empty_strided"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args, kwargs) -> int:
    """Ranks of a functional collective's group (its ``group_name``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_name":
            name = args[i] if i < len(args) else kwargs["group_name"]
            return _resolve_process_group(name).size()
    raise ValueError(f"{func}: no group name")


class Counter:
    """Per-device FLOPs, bytes, collectives and live memory of one trace."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = RL.CollectiveStats()
        self.live = 0
        self.peak = 0

    def _alloc(self, t):
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def count(self, func, args, kwargs, out):
        """One op on plain (per-device) tensors."""
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                g = _group_size(func, args, kwargs)
                for t in outs:
                    self.coll.record(kind, _nbytes(t), g)
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.is_view:
            # a view keeps its base's storage alive
            for t in outs:
                if ins:
                    t._repro_base = ins[0]
            return
        f = self.flop_registry.get(packet)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        if name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        in_ids = {id(t) for t in ins}
        for t in outs:
            if id(t) not in in_ids:
                self._alloc(t)


_COUNTER: list = []          # the active Counter (one trace at a time)


def _count(func, args, kwargs, out):
    if _COUNTER:
        _COUNTER[-1].count(func, args, kwargs, out)


class _Local(torch.Tensor):
    """A device's shard inside a ``DTensor``: wraps a ``meta`` tensor and
    counts every op run on it."""

    @staticmethod
    def __new__(cls, inner):
        return torch.Tensor._make_wrapper_subclass(
            cls, inner.shape, strides=inner.stride(),
            storage_offset=inner.storage_offset(), dtype=inner.dtype,
            device=inner.device, requires_grad=inner.requires_grad)

    def __init__(self, inner):
        self.inner = inner

    def __repr__(self):
        return f"_Local({self.inner!r})"

    def __tensor_flatten__(self):
        return ["inner"], None

    @staticmethod
    def __tensor_unflatten__(inner_tensors, meta, outer_size, outer_stride):
        return _Local(inner_tensors["inner"])

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def unwrap(t):
            return t.inner if isinstance(t, _Local) else t

        a, k = tree_map(unwrap, args), tree_map(unwrap, kwargs)
        out = func(*a, **k)
        _count(func, a, k, out)
        wrapped = tree_map(lambda t: _Local(t) if isinstance(t, torch.Tensor)
                           else t, out)
        return return_and_correct_aliasing(func, args, kwargs, wrapped)


_DTENSOR_DIR = os.path.join("torch", "distributed", "tensor")


def _in_dtensor_layer() -> bool:
    """Whether the op comes from ``DTensor``'s own bookkeeping (planning a
    redistribute, say), not from the step: such ops run once per cached
    plan, not once per call, and are no device's work."""
    f = sys._getframe(2)
    while f is not None:
        if _DTENSOR_DIR in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _replicated(func, args, kwargs):
    """Run a ``DTensor`` op with every ``DTensor`` input replicated over
    the whole mesh (the last resort, where ``DTensor`` refuses an op, or
    its strategy for the op fails or is missing: torch 2.11's ``index``,
    ``index_put`` and ``index_add`` on some placements); an in-place op
    writes a
    replicated copy and returns its target (only shapes flow on
    ``meta``)."""
    from torch.distributed.tensor import DTensor, Replicate

    def whole(t):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(t.device_mesh,
                              [Replicate()] * t.device_mesh.ndim)
    a, k = tree_map(whole, args), tree_map(whole, kwargs)
    try:
        out = func(*a, **k)
    except NotImplementedError:
        # no strategy at all: run it on the replicated shards, as a
        # replicate-everything rule would
        mesh = next(t.device_mesh for t in tree_leaves((a, k))
                    if isinstance(t, DTensor))

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t
        out = tree_map(
            lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
            if isinstance(t, torch.Tensor) else t,
            func(*tree_map(local, a), **tree_map(local, k)))
    return args[0] if func._schema.is_mutable else out


class _PlainOps(TorchDispatchMode):
    """Counts the ops on plain tensors (no ``DTensor``, no shard): every
    device runs them whole.  A ``DTensor`` op that ``DTensor`` refuses for
    its placements runs resharded (``sharding.call_resharded``; an
    in-place one on a copy, since only shapes flow on ``meta``); one that
    still fails runs with its inputs replicated (:func:`_replicated`),
    and ``fallbacks`` names it."""

    def __init__(self):
        super().__init__()
        self.fallbacks = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            # NotImplementedError: an op DTensor has no strategy for
            if not any(isinstance(t, DTensor)
                       for t in tree_leaves((args, kwargs))):
                raise
            if refused_for_placements(e):
                try:
                    return call_resharded(func, args, kwargs, e,
                                          inplace_on_copy=True)
                except RuntimeError:
                    pass
            out = _replicated(func, args, kwargs)
            name = str(func)
            self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
            return out
        if not any(isinstance(t, (DTensor, _Local))
                   for t in tree_leaves((args, kwargs))) and \
                not _in_dtensor_layer():
            _count(func, args, kwargs, out)
        return out


def _register_rules() -> None:
    """``DTensor`` rules for the ops of the traced steps that have none:
    the MoE dispatch's row-wise ``searchsorted`` (rows sharded alike, or
    everything replicated).  The bag's shape-only ops need none: a
    ``DTensor`` table takes ``ops.embedding_bag``'s sharded route, which
    runs them on local tensors."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def _searchsorted_rule(sorted_sequence, values, *args, **kwargs):
        rest = [None] * (len(args) + len(kwargs))
        out = [([R], [R, R] + rest)]
        if sorted_sequence.ndim > 1 and values.ndim > 1:
            out.append(([Shard(0)], [Shard(0), Shard(0)] + rest))
        return out


def _distribute(t, mesh, placements):
    """``t`` (a ``meta`` tensor) as a ``DTensor`` over ``mesh`` whose
    local shard is a counting :class:`_Local`."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    d = distribute_tensor(t, mesh, placements)
    return DTensor.from_local(_Local(d.to_local()), mesh, placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def _local_bytes(tree_) -> int:
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tree_leaves(tree_, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        if isinstance(t, DTensor):
            n += _nbytes(t.to_local())
        elif isinstance(t, torch.Tensor):
            n += _nbytes(t)
    return n


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Build (step, args, notes) per cell
# ---------------------------------------------------------------------------
def _cell_config(entry, ov, reduced_arch=None):
    cfg = (registry.reduced_config(reduced_arch) if reduced_arch
           else entry.config)
    for k in ("n_microbatches", "remat", "moe_ep_pad", "capacity_factor",
              "kv_quant", "n_layers"):
        if k in ov and hasattr(cfg, k):
            cfg = dataclasses.replace(cfg, **{k: ov[k]})
    if ov.get("fp32") and hasattr(cfg, "param_dtype"):
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


def cell_spec(arch: str, shape: str, ov):
    """The cell's ShapeSpec, with ``global_batch`` / ``seq_len`` from the
    overrides when given (a step timed at another batch or length)."""
    spec = registry.get_shape(arch, shape)
    kw = {k: int(ov[k]) for k in ("global_batch", "seq_len") if k in ov}
    return dataclasses.replace(spec, **kw) if kw else spec


def build_cell(arch: str, shape: str, mesh, ov, *, reduced=False):
    """``(step, args, rules, notes, cfg)``: the step function and its
    arguments laid out on ``mesh`` (``reduced``: the arch's
    ``reduced_config`` at the shape's batch and length)."""
    entry = registry.get(arch)
    spec = cell_spec(arch, shape, ov)
    cfg = _cell_config(entry, ov, arch if reduced else None)
    rules = rules_for(mesh, entry, spec, ov)
    sds = registry.input_specs(arch, shape, spec)
    notes = []
    build = {"lm": _build_lm, "gnn": _build_gnn}.get(entry.family,
                                                      _build_recsys)
    step, args = build(entry, cfg, spec, mesh, rules, sds, ov, notes)
    return step, args, rules, notes, cfg


def _params(entry, cfg, spec, rules, mesh):
    p = S.init_params_for(entry, cfg, shape_spec=spec, device="meta")
    specs = S.param_specs_for(entry, cfg, mesh_shape(mesh).get("model", 1))
    return distribute_tree(p, mesh, tree_shardings(rules, specs), _distribute)


def _inputs(sds, rules, mesh, logical):
    return {k: _distribute(_meta(*sds[k]), mesh,
                           rules.placements(logical(k, len(sds[k][0]))))
            for k in sds}


def _build_lm(entry, cfg, spec, mesh, rules, sds, ov, notes):
    params = _params(entry, cfg, spec, rules, mesh)
    q_chunk = ov.get("q_chunk", 512)
    if spec.kind in ("train", "prefill"):
        tokens = _distribute(_meta(*sds["tokens"]), mesh,
                             rules.placements(("batch", None)))
    if spec.kind == "train":
        opt = AdamW(moment_dtype=ov.get("moment_dtype"))
        n_micro = ov.get("n_microbatches", cfg.n_microbatches)
        step = S.make_lm_train_step(cfg, opt, n_microbatches=n_micro,
                                    q_chunk=q_chunk)
        return step, ("init_opt", params, tokens)
    if spec.kind == "prefill":
        return S.make_lm_prefill_step(cfg, q_chunk=q_chunk), (params, tokens)
    cache = T.init_decode_cache(cfg, spec.global_batch, spec.seq_len,
                                device="meta")
    cache = distribute_tree(cache, mesh, tree_shardings(
        rules, T.decode_cache_specs(cfg)), _distribute)
    token = _distribute(_meta(*sds["token"]), mesh,
                        rules.placements(("batch", None)))
    return S.make_lm_decode_step(cfg), (params, cache, token,
                                        spec.seq_len - 1)


def _build_gnn(entry, cfg, spec, mesh, rules, sds, ov, notes):
    dp_ways = mesh_lib.dp_extent(mesh) if "data" in mesh_shape(mesh) else 1
    e = sds["src"][0][0]
    e_pad = _pad_to(e, dp_ways * 8)
    if e_pad != e:
        notes.append(f"edges padded {e}->{e_pad} for {dp_ways}-way edge "
                     f"sharding (masked in the data pipeline)")
        for k in ("src", "dst"):
            sds[k] = ((e_pad,), torch.int32)
        sds["edge_dist"] = ((e_pad,), torch.float32)
    params = _params(entry, cfg, spec, rules, mesh)
    batch = _inputs(sds, rules, mesh, lambda k, nd: (
        ("edges",) if k in ("src", "dst", "edge_dist") else None))
    step = S.make_gnn_train_step(cfg, AdamW(), n_graphs=spec.extra("batch", 1))
    return step, ("init_opt", params, batch)


def _build_recsys(entry, cfg, spec, mesh, rules, sds, ov, notes):
    params = _params(entry, cfg, spec, rules, mesh)
    if spec.kind == "retrieval":
        step = S.make_recsys_retrieval_step(cfg, device="meta")
        user = _distribute(_meta(*sds["user_sparse"]), mesh,
                           rules.placements(None))
        cand = _distribute(_meta(*sds["cand_ids"]), mesh,
                           rules.placements(("edges",)))
        return step, (params, user, cand)
    batch = _inputs(sds, rules, mesh, lambda k, nd: (
        ("batch",) + (None,) * (nd - 1)))
    if spec.kind == "train":
        step = S.make_recsys_train_step(
            cfg, AdamW(), n_microbatches=ov.get("n_microbatches", 1))
        return step, ("init_opt", params, batch)
    return S.make_recsys_forward(cfg, device="meta"), (params, batch)


# ---------------------------------------------------------------------------
# Trace one cell
# ---------------------------------------------------------------------------
def trace_cell(arch: str, shape: str, mesh, ov, *, reduced=False) -> dict:
    """Build and trace one cell on ``mesh``; the counts of one device."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_rules()
    step, args, rules, notes, cfg = build_cell(arch, shape, mesh, ov,
                                               reduced=reduced)
    counter = Counter()
    with use_rules(rules), implicit_replication():
        if args[0] == "init_opt":
            args = (args[1], AdamW().init(args[1]), *args[2:])
        arg_bytes = _local_bytes(args)
        _COUNTER.append(counter)
        try:
            grad = torch.enable_grad() if cell_spec(
                arch, shape, ov).kind == "train" else torch.no_grad()
            with _PlainOps() as plain, grad:
                out = step(*args)
        finally:
            _COUNTER.pop()
    if plain.fallbacks:
        notes = notes + [
            "ran replicated where DTensor refused or failed the "
            "placements: " + ", ".join(f"{k} x{v}" for k, v in
                                       sorted(plain.fallbacks.items()))]
    out_bytes = _local_bytes(out)
    del out
    return dict(flops=counter.flops, bytes=counter.bytes,
                stats=counter.coll, arg_bytes=arg_bytes,
                temp_bytes=counter.peak, out_bytes=out_bytes, notes=notes,
                cfg=cfg)


def _probe_layer_counts(cfg) -> tuple:
    """Two depths for linear-in-L extrapolation: 2 and 3 layers, or 2 and
    3 groups of a local/global arch (whole groups keep the layer mix).
    Every stack holds two layers or more: a stack of one takes another
    backward (no stacking of its layers' gradients), so the counts are
    linear in L from two layers a stack on, not from one (the reference
    probes 1 and 2)."""
    if getattr(cfg, "local_global_ratio", 0):
        g = cfg.local_global_ratio + 1
        return 2 * g, 3 * g
    return 2, 3


@contextlib.contextmanager
def mesh_for(mesh_kind: str, mesh_shape_=None):
    """The cell's mesh inside its world: fake ranks for ``single``,
    ``multi`` or an explicit ``mesh_shape_`` (dims named (pod,) data,
    model); a one-rank NCCL world on the card for ``card``."""
    import torch.distributed as dist
    if mesh_kind == "card":
        if not torch.cuda.is_available():
            raise RuntimeError(CARD_NEEDS_CUDA)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            yield mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
        finally:
            dist.destroy_process_group()
        return
    if mesh_shape_ is None:
        shape, axes = mesh_lib.PRODUCTION[mesh_kind == "multi"]
    else:
        shape = tuple(mesh_shape_)
        axes = ("pod", "data", "model")[3 - len(shape):]
    n = 1
    for s_ in shape:
        n *= s_
    with C.fake_world(n):
        # cpu-typed: fake ranks move nothing, and the tensors are meta
        yield mesh_lib.make_mesh(shape, axes, "cpu")


def run_cell(arch: str, shape: str, mesh_kind: str, ov, variant="baseline",
             *, mesh_shape_=None, reduced=False) -> dict:
    """One cell's JSON record (the reference's keys)."""
    entry = registry.get(arch)
    merged = registry.overrides(arch, shape)
    merged.update(ov)
    spec = cell_spec(arch, shape, merged)
    t0 = time.time()
    with mesh_for(mesh_kind, mesh_shape_) as mesh:
        n_dev = mesh_size(mesh)
        probe = merged.pop("probe", False) and entry.family == "lm"
        if probe:
            cfg = _cell_config(entry, merged, arch if reduced else None)
            L = cfg.n_layers
            k1, k2 = _probe_layer_counts(cfg)
            runs = [trace_cell(arch, shape, mesh, dict(merged, n_layers=k),
                               reduced=reduced) for k in (k1, k2)]

            def extrap(key):
                per = (runs[1][key] - runs[0][key]) / (k2 - k1)
                return runs[0][key] + per * (L - k1)

            res = dict(runs[1])
            for key in ("flops", "bytes", "arg_bytes", "temp_bytes",
                        "out_bytes"):
                res[key] = extrap(key)
            stats = runs[1]["stats"]
            w1, w2 = runs[0]["stats"].wire_bytes, stats.wire_bytes
            wire = int(w1 + (w2 - w1) / (k2 - k1) * (L - k1))
            scale = wire / max(stats.wire_bytes, 1)
            stats.op_bytes = {k: int(v * scale)
                              for k, v in stats.op_bytes.items()}
            stats.wire_bytes = wire
            res["notes"] = res["notes"] + [
                f"extrapolated from L={k1},{k2} probes (the peak of "
                f"temporaries linearly too: approximate)"]
        else:
            res = trace_cell(arch, shape, mesh, merged, reduced=reduced)
            stats = res["stats"]
    t_trace = time.time() - t0
    notes = list(res["notes"])
    if mesh_kind != "card" and stats.op_count.get("all-gather"):
        notes.append("cpu-typed fake mesh: DTensor's shard-to-shard moves "
                     "are all-gather + chunk, counted as all-gathers")
    notes.append("flops: matmul-family ops + 1 per pointwise output element;"
                 " bytes: every op's operands, unfused")
    cfg = res["cfg"]
    hlo_bytes = res["bytes"]
    bytes_raw = hlo_bytes
    if merged.get("fp32") and getattr(entry.config, "param_dtype",
                                      "") == "bfloat16":
        hlo_bytes /= 2          # native-bf16 traffic
        notes.append("fp32-traced; memory term = bytes/2 (native bf16)")
    mem_detail = {"argument_size_in_bytes": int(res["arg_bytes"]),
                  "output_size_in_bytes": int(res["out_bytes"]),
                  "temp_size_in_bytes": int(res["temp_bytes"]),
                  "alias_size_in_bytes": 0}
    per_dev_mem = mem_detail["argument_size_in_bytes"] + \
        mem_detail["temp_size_in_bytes"]
    dtype = getattr(cfg, "compute_dtype", "float32")
    r = RL.Roofline(
        arch=arch, shape=shape, mesh=mesh_kind,
        flops=res["flops"], hlo_bytes=hlo_bytes, wire_bytes=stats.wire_bytes,
        model_flops=RL.model_flops_for(arch, shape, entry, spec),
        n_devices=n_dev, per_device_mem=int(per_dev_mem),
        collective_detail={"bytes": stats.op_bytes, "count": stats.op_count},
        notes="; ".join(notes),
        peak=RL.peak_for(dtype, tf32=bool(merged.get("tf32"))))
    out = r.to_dict()
    out.update(bytes_per_dev_raw=bytes_raw, variant=variant,
               overrides={k: str(v) for k, v in merged.items()},
               t_lower_s=round(t_trace, 1), t_compile_s=0.0,
               memory_analysis=mem_detail, ok=True)
    return out


def _parse_set(pairs):
    ov = {}
    for kv in pairs or ():
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        ov[k] = v
    return ov


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=MESH_KINDS)
    ap.add_argument("--all", action="store_true",
                    help="subprocess-per-cell sweep over the full grid")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells the sweep traces at once")
    ap.add_argument("--set", nargs="*", default=[],
                    help="hillclimb overrides k=v")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        return sweep(args)

    ov = _parse_set(args.set)
    if args.mesh == "card" and not torch.cuda.is_available():
        # refused before any output: the card route has no fallback
        raise RuntimeError(CARD_NEEDS_CUDA)
    try:
        res = run_cell(args.arch, args.shape, args.mesh, ov, args.variant)
    except Exception as e:  # record the failure; the sweep continues
        res = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "variant": args.variant, "ok": False,
               "error": f"{type(e).__name__}: {e}"}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if res.get("ok") else 1


def sweep(args):
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for ln in f:
                try:
                    r = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("variant", "baseline")))
    todo = [(a, s, m) for m in args.meshes.split(",")
            for a, s, _ in registry.cells()
            if (a, s, m, args.variant) not in done]
    failures = 0
    running = []

    def launch(arch, shape, mesh_kind):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
               "--variant", args.variant, "--out", args.out]
        if args.set:
            cmd += ["--set"] + args.set
        print(f"[sweep] {arch} x {shape} x {mesh_kind}", flush=True)
        return (arch, shape, mesh_kind, time.time(),
                subprocess.Popen(cmd, stdout=subprocess.DEVNULL))

    def reap(block: bool):
        nonlocal failures
        for item in list(running):
            arch, shape, mesh_kind, t0, proc = item
            rc = proc.poll()
            if rc is None and time.time() - t0 > args.timeout:
                proc.kill()
                rc = proc.wait()
                with open(args.out, "a") as f:
                    f.write(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "variant": args.variant, "ok": False,
                        "error": f"timeout>{args.timeout}s"}) + "\n")
            if rc is not None:
                running.remove(item)
                failures += rc != 0
        if block and running:
            time.sleep(0.2)

    try:
        for cell in todo:
            while len(running) >= max(args.jobs, 1):
                reap(block=True)
            running.append(launch(*cell))
        while running:
            reap(block=True)
    finally:
        for *_, proc in running:
            proc.kill()
            proc.wait()
    print(f"[sweep] complete, {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
