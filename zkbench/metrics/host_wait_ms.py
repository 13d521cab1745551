"""host_wait_ms: the host's seconds blocked in its waits for the card
(``zkodst_tpu_torch.utils.timing.COUNTERS["host_wait_s"]``, host clock
around each wait) over the proves it closed since the counters' last
reset, in ms a prove. In a cell of several clients, the clients'
counters summed (``Run.program_counters``). None where the program keeps
no such counters or closed no prove. Moves prove_throughput."""


def read(ctx):
    c = ctx["run"].program_counters()
    if not c or not c.get("proves") or "host_wait_s" not in c:
        return None
    return 1e3 * c["host_wait_s"] / c["proves"]
