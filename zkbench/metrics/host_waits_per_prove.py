"""host_waits_per_prove: the program's count of the host's waits for the
card (reads back, copies from the host, synchronizing ops and each
outermost span's one wait; ``zkodst_tpu_torch.utils.timing.COUNTERS``)
over the proves it closed since the counters' last reset, which the
harness makes before its traced proves. None where the program keeps no
such counters or closed no prove. Moves prove_throughput."""


def read(ctx):
    try:
        from zkodst_tpu_torch.utils.timing import COUNTERS
    except ImportError:
        return None
    if not COUNTERS.get("proves"):
        return None
    return COUNTERS["host_waits"] / COUNTERS["proves"]
