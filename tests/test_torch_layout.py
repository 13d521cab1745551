"""The port's layout view against the JAX package's: ``render_layout`` of
the BLAKE2f circuit at k = 17 (layout only, no witness) decodes to the
same pixels."""

import os

import numpy as np
import torch

from zkodst_tpu.circuit import blake2f as jbc
from zkodst_tpu.utils import layout_viz as jviz
from zkodst_tpu_torch.circuit import blake2f as tbc
from zkodst_tpu_torch.utils import layout_viz

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def test_render_layout_pixels_equal_jax(tmp_path):
    import matplotlib.image as mpimg

    got = layout_viz.render_layout(
        tbc.Blake2fCircuit(k=17, n_inst=1, device="cpu"),
        str(tmp_path / "port.png"), max_rows=300)
    want = jviz.render_layout(jbc.Blake2fCircuit(k=17, n_inst=1),
                              str(tmp_path / "jax.png"), max_rows=300)
    assert os.path.getsize(got) > 10_000
    np.testing.assert_array_equal(mpimg.imread(got), mpimg.imread(want))
