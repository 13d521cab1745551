"""host_wait_ms: the host's seconds blocked in its waits for the card
(``zkodst_tpu_torch.utils.timing.COUNTERS["host_wait_s"]``, host clock
around each wait) over the proves it closed since the counters' last
reset, in ms a prove. None where the program keeps no such counters or
closed no prove. Moves prove_throughput."""


def read(ctx):
    try:
        from zkodst_tpu_torch.utils.timing import COUNTERS
    except ImportError:
        return None
    if not COUNTERS.get("proves") or "host_wait_s" not in COUNTERS:
        return None
    return 1e3 * COUNTERS["host_wait_s"] / COUNTERS["proves"]
