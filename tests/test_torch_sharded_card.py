"""The sharded ingest on the card.  No JAX here: the card's machine
has none, so this file runs there on its own (``python -m pytest
--noconftest -m cuda tests/test_torch_sharded_card.py``) and skips
elsewhere."""
import pytest
import torch

from repro_torch.core import sharded_index as tsh
from repro_torch.core import slicepool as tsp
from repro_torch.core.pointers import PoolLayout
from repro_torch.data import synth

Z, SPP = (1, 4, 7, 11), (1024, 512, 128, 32)


@pytest.mark.cuda
def test_sharded_ingest_on_the_card_equals_the_cpu_state():
    """The sharded ingest on the card (one ``bulk_append`` launch a
    shard a batch, written through the shard's row views) leaves the
    same stacked state as the plain versions on the CPU, batch after
    batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    docs = synth.zipf_corpus(synth.CorpusSpec(vocab=300, n_docs=480,
                                              seed=5))
    layout = PoolLayout(z=Z, slices_per_pool=SPP)
    segs = [tsh.ShardedActiveSegment(layout, 300,
                                     tsh.make_doc_mesh(4, device=d))
            for d in ("cpu", "cuda")]
    ops.reset_launch_counts()
    for i in range(0, 480, 80):
        for seg in segs:
            seg.ingest(docs[i: i + 80])
        for f in tsp.PoolState._fields:
            assert torch.equal(getattr(segs[1].state, f).cpu(),
                               getattr(segs[0].state, f)), (i, f)
    assert ops.launch_counts()["bulk_append"] == 4 * 6
