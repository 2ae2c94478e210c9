"""Per-arch config module (the reference's ``configs/gemma3_12b.py``)."""
from repro_torch.configs.lm_archs import GEMMA3_12B as CONFIG

__all__ = ["CONFIG"]
