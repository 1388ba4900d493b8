"""K10's chunk table (``subtile_chunks``) against the JAX script's
``_split_bounds`` (a companion of tests/test_torch_attn_bwd_split.py)."""

import pytest
import torch

from nvit_tpu_torch.ops import flash_attention as fa
from tests.torch_attn_bwd_split_cases import jax_script

torch.set_num_threads(1)


@pytest.mark.parametrize("t", [112, 128, 784, 1104])
@pytest.mark.parametrize("nsplit", [1, 2, 7])
def test_k10_chunk_table_tiles_the_script_sub_tiles(jax_script, t, nsplit):
    """The query chunks the kernel walks (``subtile_chunks``, handed to it
    as a table): each of the JAX script's ``_split_bounds`` sub-tiles is
    covered exactly, in order, by chunks of at most 64 rows that start on a
    multiple of 16 and never cross its end."""
    sub = jax_script._split_bounds(t, nsplit)
    assert fa.split_bounds(t, nsplit) == sub
    chunks = fa.subtile_chunks(t, nsplit)
    assert chunks[0][0] == 0 and chunks[-1][1] == t
    assert all(e == a for (_, e), (a, _) in zip(chunks, chunks[1:]))  # end to end, in order
    for a, e in chunks:
        assert a % 16 == 0 and 0 < e - a <= fa.BLOCK, (a, e)
        assert sum(sa <= a and e <= se for sa, se in sub) == 1, (a, e)  # inside one sub-tile
    for sa, se in sub:
        assert [c for c in chunks if sa <= c[0] < se][-1][1] == se
