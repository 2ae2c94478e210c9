"""The embedding-bag backward kernel's plan, on the CPU.

``kernels.embedding_bag.sort_positions`` (the plan's stable sort by
clipped row, and a window's chunk shift) and ``backward_plan`` (lanes,
vector width, chunks, bitmap words) are the wrapper's own code and run
here; the kernel itself runs only on the card (``tests/test_torch_guards.py``'s
card tests).
"""
import pytest
import torch

from repro_torch.kernels import embedding_bag as teb


def test_sort_positions():
    """Clipped rows sorted stably (equal rows in position order); the
    positions outside [offsets[0], offsets[B]) get row R and sort last;
    the whole table has no chunk shift."""
    idx = torch.tensor([5, -2, 9, 5, 0, 7, 5, 100], dtype=torch.int32)
    off = torch.tensor([1, 3, 3, 7], dtype=torch.int32)   # 0 and 7 outside
    key, perm, phase = teb.sort_positions(idx, off, 10)
    assert key.dtype == perm.dtype == torch.int32
    assert key.tolist() == [0, 0, 5, 5, 7, 9, 10, 10]
    assert perm.tolist() == [1, 4, 3, 6, 5, 2, 0, 7]
    assert phase is None


@pytest.mark.parametrize("D", [1, 10, 16, 18, 128, 256])
@pytest.mark.parametrize("shift", [0, 4, 8])
@pytest.mark.parametrize("rows", [1, 31, 32, 3_000_017])
def test_backward_plan(D, shift, rows):
    """What the kernel relies on: its vector loads are aligned and divide
    a row, a group of lanes spans a row (or 32 vectors of it), the chunks
    cover every sorted entry (one more for a shifted window, none for no
    entry), and the bitmap has a bit for every row."""
    n = 1_000_003
    p = teb.backward_plan(D, 1 << 20 | shift, n, rows)
    assert D % p.vec == 0 and shift % (4 * p.vec) == 0
    assert p.lanes <= 32 and p.lanes * p.vec >= min(D, 32 * p.vec)
    assert p.n_chunks * teb.BWD_CHUNK >= n > (p.n_chunks - 1) * teb.BWD_CHUNK
    assert p.words * 32 >= rows > (p.words - 1) * 32
    shifted = teb.backward_plan(D, 1 << 20 | shift, n, rows, shifted=True)
    assert shifted.n_chunks == p.n_chunks + 1
    assert teb.backward_plan(D, 1 << 20, 0, rows).n_chunks == 0
