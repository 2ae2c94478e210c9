"""Per-arch config module (the reference's ``configs/dcn_v2.py``)."""
from repro_torch.configs.other_archs import DCN_V2 as CONFIG

__all__ = ["CONFIG"]
