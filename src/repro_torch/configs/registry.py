"""Architecture registry: ``--arch`` ids -> config, shapes, input specs
(the reference's ``configs/registry.py``).

``input_specs(arch, shape)`` returns ``(shape, torch.dtype)`` pairs where
the reference returns ``jax.ShapeDtypeStruct`` stand-ins.  ``cells()``
walks the (arch x shape) grid without the skipped cells, and
``overrides(arch, shape)`` gives a cell's dry-run knobs
(:data:`DRYRUN_OVERRIDES`, read by ``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.configs import lm_archs, other_archs
from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                      GNNConfig, LMConfig, RecsysConfig,
                                      ShapeSpec)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    family: str                      # lm | gnn | recsys
    config: Union[LMConfig, GNNConfig, RecsysConfig]
    shapes: Tuple[ShapeSpec, ...]
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""


_FULL_ATTN_SKIP = (
    "long_500k requires sub-quadratic attention structure; this arch is "
    "pure full-attention (DESIGN.md §4 records the skip)."
)

ARCHS: Dict[str, ArchEntry] = {
    "tinyllama-1.1b": ArchEntry("lm", lm_archs.TINYLLAMA_1B, LM_SHAPES,
                                ("long_500k",), _FULL_ATTN_SKIP),
    "gemma3-12b": ArchEntry("lm", lm_archs.GEMMA3_12B, LM_SHAPES),
    "deepseek-coder-33b": ArchEntry("lm", lm_archs.DEEPSEEK_CODER_33B,
                                    LM_SHAPES, ("long_500k",),
                                    _FULL_ATTN_SKIP),
    "qwen2-moe-a2.7b": ArchEntry("lm", lm_archs.QWEN2_MOE_A2_7B, LM_SHAPES,
                                 ("long_500k",), _FULL_ATTN_SKIP),
    "grok-1-314b": ArchEntry("lm", lm_archs.GROK_1_314B, LM_SHAPES,
                             ("long_500k",), _FULL_ATTN_SKIP),
    "schnet": ArchEntry("gnn", other_archs.SCHNET, GNN_SHAPES),
    "xdeepfm": ArchEntry("recsys", other_archs.XDEEPFM, RECSYS_SHAPES),
    "dcn-v2": ArchEntry("recsys", other_archs.DCN_V2, RECSYS_SHAPES),
    "dlrm-mlperf": ArchEntry("recsys", other_archs.DLRM_MLPERF,
                             RECSYS_SHAPES),
    "dien": ArchEntry("recsys", other_archs.DIEN, RECSYS_SHAPES),
}


def get(arch: str) -> ArchEntry:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_shape(arch: str, shape: str) -> ShapeSpec:
    for s in get(arch).shapes:
        if s.name == shape:
            return s
    raise KeyError(f"unknown shape {shape!r} for {arch}")


def cells(include_skipped: bool = False):
    """Every (arch, shape, skipped) cell of the grid."""
    for arch, entry in ARCHS.items():
        for s in entry.shapes:
            skipped = s.name in entry.skip_shapes
            if skipped and not include_skipped:
                continue
            yield arch, s.name, skipped


def _gnn_sample_sizes(spec: ShapeSpec) -> Tuple[int, int]:
    """Padded (n_nodes, n_edges) for the lowered graph batch."""
    if spec.name == "minibatch_lg":
        b = spec.extra("batch_nodes")
        f1, f2 = spec.extra("fanout")
        hop1 = b * f1
        hop2 = (b + hop1) * f2
        return b + hop1 + hop2, hop1 + hop2       # sampled subgraph
    if spec.name == "molecule":
        b = spec.extra("batch")
        return b * spec.extra("n_nodes"), b * spec.extra("n_edges")
    return spec.extra("n_nodes"), spec.extra("n_edges")


def input_specs(arch: str, shape: str, spec: ShapeSpec = None) -> dict:
    """``(shape, dtype)`` of each of the step function's data arguments
    (``spec``: the cell's shape with another batch or length)."""
    entry = get(arch)
    spec = spec or get_shape(arch, shape)
    B = spec.global_batch
    if entry.family == "lm":
        if spec.kind in ("train", "prefill"):
            return {"tokens": ((B, spec.seq_len), torch.int32)}
        # decode: one new token; the KV cache is carried state, not input
        return {"token": ((B, 1), torch.int32), "pos": ((), torch.int32)}
    if entry.family == "gnn":
        n, e = _gnn_sample_sizes(spec)
        out = {"src": ((e,), torch.int32), "dst": ((e,), torch.int32),
               "edge_dist": ((e,), torch.float32),
               "graph_id": ((n,), torch.int32)}
        if spec.name == "molecule":
            out["atom_type"] = ((n,), torch.int32)
            out["targets"] = ((spec.extra("batch"),), torch.float32)
        else:
            out["node_feat"] = ((n, spec.extra("d_feat")), torch.float32)
            out["targets"] = ((1,), torch.float32)
        return out
    cfg: RecsysConfig = entry.config
    if spec.kind == "retrieval":
        return {"user_sparse": ((1, cfg.n_sparse), torch.int32),
                "cand_ids": ((spec.extra("n_candidates"),), torch.int32)}
    out = {"sparse": ((B, cfg.n_sparse), torch.int32)}
    if cfg.n_dense:
        out["dense"] = ((B, cfg.n_dense), torch.float32)
    if cfg.interaction == "augru":
        out["hist"] = ((B, cfg.seq_len, 2), torch.int32)
        out["hist_len"] = ((B,), torch.int32)
    if spec.kind == "train":
        out["label"] = ((B,), torch.float32)
    return out


# ---------------------------------------------------------------------------
# Per-cell dry-run overrides (fit-memory knobs)
# ---------------------------------------------------------------------------
DRYRUN_OVERRIDES: Dict[Tuple[str, str], dict] = {
    # (arch, shape): dict(n_microbatches=..., q_chunk=..., seq_sharded=...)
    ("tinyllama-1.1b", "train_4k"): dict(n_microbatches=2, q_chunk=512),
    ("gemma3-12b", "train_4k"): dict(n_microbatches=4, q_chunk=512),
    ("deepseek-coder-33b", "train_4k"): dict(n_microbatches=8, q_chunk=256),
    ("qwen2-moe-a2.7b", "train_4k"): dict(n_microbatches=4, q_chunk=512),
    ("grok-1-314b", "train_4k"): dict(n_microbatches=8, q_chunk=256),
    ("tinyllama-1.1b", "prefill_32k"): dict(q_chunk=256, seq_sharded=True),
    ("gemma3-12b", "prefill_32k"): dict(q_chunk=256, seq_sharded=True),
    ("deepseek-coder-33b", "prefill_32k"): dict(q_chunk=128,
                                                seq_sharded=True),
    ("qwen2-moe-a2.7b", "prefill_32k"): dict(q_chunk=256, seq_sharded=True),
    ("grok-1-314b", "prefill_32k"): dict(q_chunk=128, seq_sharded=True),
}


def overrides(arch: str, shape: str) -> dict:
    return dict(DRYRUN_OVERRIDES.get((arch, shape), {}))


def reduced_config(arch: str):
    """Tiny same-family config for CPU smoke tests (the reference's
    ``reduced_config``)."""
    entry = get(arch)
    cfg = entry.config
    if entry.family == "gnn":
        return dataclasses.replace(cfg, n_rbf=16)
    if entry.family == "recsys":
        # shrink tables
        small_vocab = tuple(min(v, 1000) for v in cfg.vocab_sizes)
        return dataclasses.replace(cfg, vocab_sizes=small_vocab)
    kw = dict(
        name=cfg.name + "-smoke", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=max(1, cfg.n_kv_heads // 8),
        d_head=16, d_ff=128, vocab=256,
        param_dtype="float32", compute_dtype="float32",
        rope_theta=cfg.rope_theta, remat=False,
    )
    if cfg.moe:
        # capacity_factor high enough that smoke tests never drop
        # tokens (keeps prefill/decode paths bit-consistent).
        kw.update(moe=True, n_experts=max(4, cfg.n_experts // 8),
                  moe_top_k=min(2, cfg.moe_top_k),
                  n_shared_experts=min(1, cfg.n_shared_experts),
                  moe_d_ff=64, capacity_factor=8.0)
    if cfg.local_global_ratio:
        kw.update(sliding_window=8, local_global_ratio=1, n_layers=2)
    return dataclasses.replace(cfg, **kw)
