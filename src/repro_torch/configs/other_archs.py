"""GNN + recsys assigned architectures (exact public configs; copies of
the reference's ``configs/other_archs.py``)."""
from repro_torch.configs.base import GNNConfig, RecsysConfig

# [arXiv:1706.08566; paper]
SCHNET = GNNConfig(
    name="schnet", n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0,
)

# Criteo-Kaggle per-field vocabularies (public, DeepCTR reference)
_CRITEO_KAGGLE_26 = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

# Criteo-1TB per-field vocabularies (MLPerf DLRM reference)
_CRITEO_TB_26 = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
)

# [arXiv:1803.05170; paper] — 39 fields = 13 bucketised dense + 26 categorical
XDEEPFM = RecsysConfig(
    name="xdeepfm", interaction="cin", n_dense=0, n_sparse=39, embed_dim=10,
    vocab_sizes=tuple([100] * 13) + _CRITEO_KAGGLE_26,
    cin_layers=(200, 200, 200), top_mlp=(400, 400),
)

# [arXiv:2008.13535; paper]
DCN_V2 = RecsysConfig(
    name="dcn-v2", interaction="cross", n_dense=13, n_sparse=26,
    embed_dim=16, vocab_sizes=_CRITEO_KAGGLE_26,
    n_cross_layers=3, top_mlp=(1024, 1024, 512),
)

# [arXiv:1906.00091; paper] — MLPerf DLRM (Criteo 1TB)
DLRM_MLPERF = RecsysConfig(
    name="dlrm-mlperf", interaction="dot", n_dense=13, n_sparse=26,
    embed_dim=128, vocab_sizes=_CRITEO_TB_26,
    bot_mlp=(13, 512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
)

# [arXiv:1809.03672; unverified] — item + category fields, 1M items
DIEN = RecsysConfig(
    name="dien", interaction="augru", n_dense=0, n_sparse=2, embed_dim=18,
    vocab_sizes=(1_000_000, 10_000), seq_len=100, gru_dim=108,
    top_mlp=(200, 80),
)
