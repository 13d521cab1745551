"""The port's mock checker on the BLAKE2f witness at k = 17 (one round,
one instance) with one cell flipped in a limb column (``d1``, ``s1``):
the failure lists equal the JAX package's, pinned in
``test_torch_mock.py``. A file of its own, so that the k = 17 checks
spread over the test workers."""

import pytest
import torch

from test_torch_mock import check_blake2f_cell

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("col", ["d1", "s1"])
def test_flipped_limb_cell_fails_as_jax(col):
    check_blake2f_cell(col)
