"""Per-arch config module (the reference's ``configs/qwen2_moe_a2_7b.py``)."""
from repro_torch.configs.lm_archs import QWEN2_MOE_A2_7B as CONFIG

__all__ = ["CONFIG"]
