"""Per-arch config module (the reference's ``configs/dlrm_mlperf.py``)."""
from repro_torch.configs.other_archs import DLRM_MLPERF as CONFIG

__all__ = ["CONFIG"]
