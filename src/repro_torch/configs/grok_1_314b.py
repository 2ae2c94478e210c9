"""Per-arch config module (the reference's ``configs/grok_1_314b.py``)."""
from repro_torch.configs.lm_archs import GROK_1_314B as CONFIG

__all__ = ["CONFIG"]
