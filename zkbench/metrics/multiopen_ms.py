"""multiopen_ms: the opening (``prove.multiopen``: SHPLONK's W and W′ over
KZG, its reduction and the inner-product argument over IPA), mean ms a
prove over the window. Moves prove_throughput."""


def read(ctx):
    return ctx["run"].phase_mean_ms(["prove.multiopen"])
