"""launches_per_prove: the program's own launch counters (the twelve
kernels' wrappers and the BLAKE2f kernels') over the traced proves,
divided by their number. In a cell of several clients, both summed over
the clients' traced proves. Moves prove_throughput."""


def read(ctx):
    la = ctx["run"].launches
    if not la or not la["proves"]:
        return None
    return sum(la["counts"].values()) / la["proves"]
