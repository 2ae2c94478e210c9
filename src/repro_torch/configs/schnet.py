"""Per-arch config module (the reference's ``configs/schnet.py``)."""
from repro_torch.configs.other_archs import SCHNET as CONFIG

__all__ = ["CONFIG"]
