"""ntt_roofline_pct: the NTT layer's least time under the frozen work model
(``roofline/ntt.py``: the larger of its butterflies' 32-bit multiplies
at the card's peak and one read and one write of the batch at 3.35 TB/s,
transform by transform) as a share of the device time of the program's
``.ntt`` spans (each span's CUDA event pair) over the window's proves
(``Run.ntt_window``; in a cell of several clients, every client's window
proves). None where the card's peak could not be read or the program
keeps no such spans. Moves prove_throughput."""

from zkbench.roofline import ntt


def read(ctx):
    run = ctx["run"]
    proves = run.ntt_window()
    if proves is None:
        return None
    return ntt.roofline_pct((sp for spans in proves for sp in spans),
                            run.card)
