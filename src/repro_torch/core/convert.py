"""Carry index state across between the reference package and the port.

The boundary is plain numpy in the reference's dtypes, so neither
package imports the other: the seven ``PoolState`` leaves (uint32 heap
and tail, int32 watermark/freq/free_list/free_count, bool overflow) and
each frozen segment's CSR (``offsets``/``data``/``n_docs``/``doc_base``/
``tier``; per shard for a sharded segment).  :func:`load_lifecycle`
installs such a state into a port ``LifecycleEngine`` or
``ShardedLifecycleEngine`` — which then computes exactly what the reference
engine would — and :func:`dump_lifecycle` reads one back out.

The LM side carries a reference ``init_lm`` parameter tree (nested
dicts of numpy arrays) and a ``PagedKVState`` (uint32 ``link``/``tail``
as int64 here) across the same way, and the recsys side a reference
recsys parameter tree (dicts and lists of numpy arrays).  An optimizer
state (``AdamWState`` or ``CompressedState``, any object with those
fields) crosses as its parameter trees do.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.segments import FrozenSegment
from repro_torch.core.sharded_index import ShardedFrozenSegment
from repro_torch.core.slicepool import PoolState
from repro_torch.paged.kv_cache import PagedKVState
from repro_torch.train.compression import CompressedState
from repro_torch.train.optimizer import AdamWState

# reference dtype of each PoolState leaf; torch carries uint32 as int64
POOL_DTYPES = {"heap": np.uint32, "watermark": np.int32, "tail": np.uint32,
               "freq": np.int32, "overflow": np.bool_,
               "free_list": np.int32, "free_count": np.int32}
FROZEN_FIELDS = ("offsets", "data", "n_docs", "doc_base", "tier")


def pool_state_from_numpy(leaves: Mapping[str, np.ndarray],
                          device="cuda") -> PoolState:
    """The port's ``PoolState`` from the reference's seven leaves."""
    out = {}
    for f, dt in POOL_DTYPES.items():
        a = np.asarray(leaves[f])
        if a.dtype != dt:
            raise TypeError(f"leaf {f}: expected {np.dtype(dt)}, got "
                            f"{a.dtype}")
        # astype copies into a contiguous array and keeps 0-d leaves 0-d
        out[f] = torch.from_numpy(
            a.astype(np.int64 if dt is np.uint32 else dt)).to(device)
    return PoolState(**out)


def pool_state_to_numpy(state: PoolState) -> Dict[str, np.ndarray]:
    """The reference's seven leaves (its dtypes) from a port state."""
    return {f: getattr(state, f).cpu().numpy().astype(dt)
            for f, dt in POOL_DTYPES.items()}


def frozen_from_numpy(fz):
    """A port ``FrozenSegment`` from anything with the CSR fields (the
    reference's ``FrozenSegment``, or a mapping of them); a sharded one
    (with ``shards``, each such a CSR) becomes a port
    ``ShardedFrozenSegment``."""
    get = (fz.__getitem__ if isinstance(fz, Mapping)
           else lambda f: getattr(fz, f))
    shards = (fz.get("shards") if isinstance(fz, Mapping)
              else getattr(fz, "shards", None))
    if shards is not None:
        return ShardedFrozenSegment(
            [frozen_from_numpy(sh) for sh in shards],
            n_docs=int(get("n_docs")), doc_base=int(get("doc_base")),
            tier=int(get("tier")))
    return FrozenSegment(offsets=np.asarray(get("offsets"), np.int64),
                         data=np.asarray(get("data"), np.uint32),
                         n_docs=int(get("n_docs")),
                         doc_base=int(get("doc_base")),
                         freed_slices=None, tier=int(get("tier")))


def frozen_to_numpy(fz) -> Dict[str, object]:
    if isinstance(fz, ShardedFrozenSegment):
        return {"shards": [frozen_to_numpy(sh) for sh in fz.shards],
                "n_docs": fz.n_docs, "doc_base": fz.doc_base,
                "tier": fz.tier}
    return {f: getattr(fz, f) for f in FROZEN_FIELDS}


def load_lifecycle(engine, leaves: Mapping[str, np.ndarray],
                   frozen: Sequence, *, next_docid: int, doc_base: int,
                   n_rollovers: int = 0, n_compactions: int = 0) -> None:
    """Install a reference engine's state into the port ``engine``
    (single-device or sharded, with stacked ``[S, ...]`` leaves): the
    active segment's pool leaves and docid count, the frozen segments
    (oldest first), the docid base and the rollover/compaction
    counters."""
    segs = engine.segments
    segs.active = segs._new_active(
        state=pool_state_from_numpy(leaves, engine.device))
    segs.active.next_docid = int(next_docid)
    segs.frozen = [frozen_from_numpy(fz) for fz in frozen]
    segs._doc_base = int(doc_base)
    segs.n_rollovers = int(n_rollovers)
    segs.n_compactions = int(n_compactions)
    engine._sync_frozen()


def dump_lifecycle(engine) -> Dict[str, object]:
    """The inverse of :func:`load_lifecycle`, as plain numpy/ints."""
    segs = engine.segments
    return dict(leaves=pool_state_to_numpy(segs.active.state),
                frozen=[frozen_to_numpy(fz) for fz in segs.frozen],
                next_docid=segs.active.next_docid, doc_base=segs._doc_base,
                n_rollovers=segs.n_rollovers,
                n_compactions=segs.n_compactions)


# ---------------------------------------------------------------------------
# LM parameters and the paged KV state
# ---------------------------------------------------------------------------
KV_DTYPES = {"link": np.uint32, "watermark": np.int32, "tail": np.uint32,
             "length": np.int32, "overflow": np.bool_}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A tensor from a numpy array; numpy bfloat16 (the ml_dtypes type
    JAX hands out) travels as its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a copy: numpy keeps its own
    return t.to(device=device, dtype=dtype)


def _map_tree(fn, node, key=None):
    """``fn(leaf, key)`` on every array leaf of a tree of dicts and lists
    (``key``: the name of the leaf's innermost dict entry)."""
    if isinstance(node, Mapping):
        return {k: _map_tree(fn, v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_tree(fn, v, key) for v in node]
    return fn(node, key)


def _leaf_to_numpy(t: torch.Tensor, key=None) -> np.ndarray:
    """numpy has no bfloat16, so a bf16 leaf comes back as float32
    (exactly)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_from_numpy(tree, cfg, device="cuda") -> dict:
    """The port's parameters from a reference init tree of numpy arrays
    (``init_lm``'s dicts with stacked ``[L, ...]`` layers, or a recsys
    ``init_*``'s dicts holding lists of layer dicts such as
    ``bot``/``top``, ``cross``, ``cin``): the same names and nesting, in
    the config's ``param_dtype`` (an MoE ``router`` in fp32); bf16 leaves
    travel as their bit pattern."""
    dt = getattr(torch, cfg.param_dtype)
    # the MoE router stays fp32, as the reference's init makes it
    return _map_tree(lambda a, key: _tensor(
        a, device, torch.float32 if key == "router" else dt), tree)


def params_to_numpy(params) -> dict:
    """The inverse of :func:`params_from_numpy` (bf16 leaves as
    float32)."""
    return _map_tree(_leaf_to_numpy, params)


lm_params_from_numpy = recsys_params_from_numpy = params_from_numpy
lm_params_to_numpy = recsys_params_to_numpy = params_to_numpy


def opt_state_from_numpy(state, device="cuda"):
    """The port's ``AdamWState`` (or ``CompressedState``) from the
    reference's, its leaves numpy arrays: ``step`` int32, each moment in
    its array's dtype (the moment dtype; bf16 travels as its bit
    pattern), the residuals fp32."""
    if hasattr(state, "residual"):
        return CompressedState(
            inner=opt_state_from_numpy(state.inner, device),
            residual=_map_tree(lambda a, key: _tensor(
                a, device, torch.float32), state.residual))
    return AdamWState(
        step=_tensor(state.step, device, torch.int32),
        mu=_map_tree(lambda a, key: _tensor(a, device), state.mu),
        nu=_map_tree(lambda a, key: _tensor(a, device), state.nu))


def opt_state_to_numpy(state) -> dict:
    """The inverse of :func:`opt_state_from_numpy` as a dict of the
    fields (``step``, ``mu``, ``nu``, or ``inner`` and ``residual``);
    bf16 leaves as float32."""
    if hasattr(state, "residual"):
        return {"inner": opt_state_to_numpy(state.inner),
                "residual": _map_tree(_leaf_to_numpy, state.residual)}
    return {"step": _leaf_to_numpy(state.step),
            "mu": _map_tree(_leaf_to_numpy, state.mu),
            "nu": _map_tree(_leaf_to_numpy, state.nu)}


def kv_state_from_numpy(leaves: Mapping[str, np.ndarray],
                        device="cuda") -> PagedKVState:
    """The port's ``PagedKVState`` from the reference's seven leaves."""
    out = {}
    for f, dt in KV_DTYPES.items():
        a = np.asarray(leaves[f])
        if a.dtype != dt:
            raise TypeError(f"leaf {f}: expected {np.dtype(dt)}, got "
                            f"{a.dtype}")
        out[f] = torch.from_numpy(
            a.astype(np.int64 if dt is np.uint32 else dt)).to(device)
    for f in ("k_heap", "v_heap"):
        out[f] = _tensor(leaves[f], device)
    return PagedKVState(**out)


def kv_state_to_numpy(state: PagedKVState) -> Dict[str, np.ndarray]:
    """The reference's leaves (its dtypes; bf16 heaps as float32) from a
    port state."""
    out = {f: getattr(state, f).cpu().numpy().astype(dt)
           for f, dt in KV_DTYPES.items()}
    for f in ("k_heap", "v_heap"):
        out[f] = _leaf_to_numpy(getattr(state, f))
    return out
