"""The port's mock checker on the BLAKE2f witness at k = 17 (one round,
one instance) with one cell flipped in a word or operand column (``w``,
``ca``, ``ce``): the failure lists equal the JAX package's, pinned in
``test_torch_mock.py``. A file of its own, so that the k = 17 checks
spread over the test workers."""

import pytest
import torch

from test_torch_mock import check_blake2f_cell

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("col", ["w", "ca", "ce"])
def test_flipped_word_cell_fails_as_jax(col):
    check_blake2f_cell(col)
