"""host_waits_per_prove: the program's count of the host's waits for the
card (reads back, copies from the host over ``timing.UPLOAD_MAX``,
synchronizing ops, a staging slot still in flight and each outermost
span's one wait; ``zkodst_tpu_torch.utils.timing.COUNTERS``) over the
proves it closed since the counters' last reset, which the harness makes
before its traced proves. In a cell of several clients, the clients'
counters summed (``Run.program_counters``). None where the program keeps
no such counters or closed no prove. Moves prove_throughput."""


def read(ctx):
    c = ctx["run"].program_counters()
    if not c or not c.get("proves"):
        return None
    return c["host_waits"] / c["proves"]
