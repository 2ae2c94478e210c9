"""Per-arch config module (the reference's ``configs/deepseek_coder_33b.py``)."""
from repro_torch.configs.lm_archs import DEEPSEEK_CODER_33B as CONFIG

__all__ = ["CONFIG"]
