"""witness_ms: the circuit's witness (``prove.witness``: the inputs'
upload and kernel 13 writing the advice and public columns), mean ms a
prove over the window. Moves prove_throughput."""


def read(ctx):
    return ctx["run"].phase_mean_ms(["prove.witness"])
