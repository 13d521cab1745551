"""ntt_ms: the NTT layer's device time (every program span whose label ends
in ``.ntt``: one for each outermost call of ``ops.ntt.ntt``, ``intt``,
``coset_ntt`` and ``coset_intt``, through ``proof.domain`` too; each
span's CUDA event pair, so the work queued before the transform is not
counted), summed over a prove, mean ms a prove over the window's proves
(``Run.ntt_window``; in a cell of several clients, every client's window
proves). None where the program keeps no such spans or they have no
device time. Moves prove_throughput."""

from zkbench.roofline import ntt


def read(ctx):
    return ntt.device_ms(ctx["run"].ntt_window())
