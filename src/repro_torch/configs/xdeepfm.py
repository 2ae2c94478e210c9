"""Per-arch config module (the reference's ``configs/xdeepfm.py``)."""
from repro_torch.configs.other_archs import XDEEPFM as CONFIG

__all__ = ["CONFIG"]
