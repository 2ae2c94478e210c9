"""The five assigned LM architectures (exact public configs)."""
from repro_torch.configs.base import LMConfig

# [arXiv:2401.02385; hf] — llama2-arch small
TINYLLAMA_1B = LMConfig(
    name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=5632, vocab=32000,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

# [hf:google/gemma-3-1b-pt lineage; unverified] — 5:1 local:global, 128k ctx
GEMMA3_12B = LMConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
    n_kv_heads=8, d_head=256, d_ff=15360, vocab=262144,
    sliding_window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16", fsdp=True,
)

# [arXiv:2401.14196; hf] — llama-arch
DEEPSEEK_CODER_33B = LMConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=19200, vocab=32256,
    param_dtype="bfloat16", compute_dtype="bfloat16", fsdp=True,
)

# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed top-4
QWEN2_MOE_A2_7B = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=151936,
    moe=True, n_experts=60, moe_top_k=4, n_shared_experts=4, moe_d_ff=1408,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

# [hf:xai-org/grok-1; unverified] — 8 experts top-2
GROK_1_314B = LMConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072,
    moe=True, n_experts=8, moe_top_k=2, n_shared_experts=0, moe_d_ff=32768,
    param_dtype="bfloat16", compute_dtype="bfloat16", fsdp=True,
)
