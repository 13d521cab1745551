"""constraints_ms: the quotient's constraint evaluation (the program's
span ``prove.quotient.constraints``: ``quotient_eval``, the key's
compiled tape of the gates over the extended coset in one launch of
kernel 15), mean ms a prove over the window.
None where the program has no such span. Moves prove_throughput."""


def read(ctx):
    return ctx["run"].phase_mean_ms(["prove.quotient.constraints"])
