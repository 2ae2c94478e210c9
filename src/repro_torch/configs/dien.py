"""Per-arch config module (the reference's ``configs/dien.py``)."""
from repro_torch.configs.other_archs import DIEN as CONFIG

__all__ = ["CONFIG"]
