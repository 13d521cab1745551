"""uploads_per_prove: the program's count of its copies from the host that
do not wait for the card (staged in pinned memory and enqueued on the
stream; ``zkodst_tpu_torch.utils.timing.COUNTERS["uploads"]``) over the
proves it closed since the counters' last reset, which the harness makes
before its traced proves. In a cell of several clients, the clients'
counters summed (``Run.program_counters``). None where the program keeps
no such counter or closed no prove. Moves prove_throughput."""


def read(ctx):
    c = ctx["run"].program_counters()
    if not c or not c.get("proves") or "uploads" not in c:
        return None
    return c["uploads"] / c["proves"]
