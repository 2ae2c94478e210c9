"""Config dataclasses and input-shape specs (copies of the reference's
``ShapeSpec``, ``LMConfig``, ``GNNConfig``, ``RecsysConfig``,
``LM_SHAPES``, ``GNN_SHAPES`` and ``RECSYS_SHAPES``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (arch x shape grid)."""
    name: str
    kind: str                    # train | prefill | decode | serve | retrieval
    seq_len: int = 0
    global_batch: int = 0
    extras: tuple = ()           # family-specific (sorted key/value pairs)

    def extra(self, key, default=None):
        return dict(self.extras).get(key, default)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_ep_pad: int = 0     # pad expert arrays to this count for EP
                            # sharding (router still uses n_experts)
    # attention pattern (gemma3: 5 local / 1 global)
    sliding_window: Optional[int] = None
    local_global_ratio: int = 0        # k local layers per global; 0 = all global
    rope_theta: float = 10_000.0
    # numerics / scale knobs
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    fsdp: bool = False                 # shard params over data axis too
    remat: bool = True
    n_microbatches: int = 1
    tie_embeddings: bool = False
    kv_quant: bool = False   # int8 KV cache w/ per-(token,head) scales
    unroll_layers: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def param_count(self) -> int:
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        dense_mlp = 3 * d * f
        per_layer = attn
        if self.moe:
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            per_layer += self.n_shared_experts * 3 * d * self.moe_d_ff
            per_layer += d * self.n_experts  # router
        else:
            per_layer += dense_mlp
        return L * per_layer + 2 * V * d

    @property
    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count
        d, L = self.d_model, self.n_layers
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        act = attn + (self.moe_top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff \
            + d * self.n_experts
        return L * act + 2 * self.vocab * d


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_interactions: int
    d_hidden: int
    n_rbf: int
    cutoff: float
    d_feat_default: int = 128
    param_dtype: str = "float32"
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str                 # dot | cross | cin | augru
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_sizes: Tuple[int, ...]     # one per sparse field
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    n_cross_layers: int = 0
    cin_layers: Tuple[int, ...] = ()
    # DIEN
    seq_len: int = 0
    gru_dim: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    unroll_seq: bool = False         # the reference's scan unroll knob

    @property
    def total_rows(self) -> int:
        return sum(self.vocab_sizes)


LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              extras=(("n_nodes", 2708), ("n_edges", 10556),
                      ("d_feat", 1433))),
    ShapeSpec("minibatch_lg", "train",
              extras=(("n_nodes", 232_965), ("n_edges", 114_615_892),
                      ("batch_nodes", 1024), ("fanout", (15, 10)),
                      ("d_feat", 602))),
    ShapeSpec("ogb_products", "train",
              extras=(("n_nodes", 2_449_029), ("n_edges", 61_859_140),
                      ("d_feat", 100))),
    ShapeSpec("molecule", "train",
              extras=(("n_nodes", 30), ("n_edges", 64), ("batch", 128))),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", global_batch=65_536),
    ShapeSpec("serve_p99", "serve", global_batch=512),
    ShapeSpec("serve_bulk", "serve", global_batch=262_144),
    ShapeSpec("retrieval_cand", "retrieval", global_batch=1,
              extras=(("n_candidates", 1_000_000),)),
)
