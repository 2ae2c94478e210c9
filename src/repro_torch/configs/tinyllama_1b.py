"""Per-arch config module (the reference's ``configs/tinyllama_1b.py``)."""
from repro_torch.configs.lm_archs import TINYLLAMA_1B as CONFIG

__all__ = ["CONFIG"]
