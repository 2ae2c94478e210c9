"""Architecture registry, LM part: ``--arch`` ids -> config.

The reference's registry also maps the GNN and recsys archs and builds
``input_specs``/dry-run overrides from JAX stand-ins; those wait for
ROADMAP.md Queue 1 item 12, and asking for such an arch here raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import lm_archs
from repro_torch.configs.base import LMConfig


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    family: str                      # lm (gnn | recsys not ported yet)
    config: LMConfig


ARCHS: Dict[str, ArchEntry] = {
    "tinyllama-1.1b": ArchEntry("lm", lm_archs.TINYLLAMA_1B),
    "gemma3-12b": ArchEntry("lm", lm_archs.GEMMA3_12B),
    "deepseek-coder-33b": ArchEntry("lm", lm_archs.DEEPSEEK_CODER_33B),
    "qwen2-moe-a2.7b": ArchEntry("lm", lm_archs.QWEN2_MOE_A2_7B),
    "grok-1-314b": ArchEntry("lm", lm_archs.GROK_1_314B),
}
_NOT_PORTED = ("schnet", "xdeepfm", "dcn-v2", "dlrm-mlperf", "dien")


def get(arch: str) -> ArchEntry:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: the GNN/recsys configs are not ported yet (ROADMAP.md "
            f"Queue 1 item 12)")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def reduced_config(arch: str) -> LMConfig:
    """Tiny same-family config for CPU smoke tests (the reference's
    ``reduced_config``, LM branch)."""
    cfg = get(arch).config
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
