"""commit_ms: the prover's commitments before the quotient
(``prove.advice_commit`` + ``prove.lookup_permute`` +
``prove.grand_products_commit``), mean ms a prove over the window.
Moves prove_throughput."""


def read(ctx):
    return ctx["run"].phase_mean_ms(["prove.advice_commit",
                                     "prove.lookup_permute",
                                     "prove.grand_products_commit"])
