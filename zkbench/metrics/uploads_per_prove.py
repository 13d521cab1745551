"""uploads_per_prove: the program's count of its copies from the host that
do not wait for the card (staged in pinned memory and enqueued on the
stream; ``zkodst_tpu_torch.utils.timing.COUNTERS["uploads"]``) over the
proves it closed since the counters' last reset, which the harness makes
before its traced proves. None where the program keeps no such counter or
closed no prove. Moves prove_throughput."""


def read(ctx):
    try:
        from zkodst_tpu_torch.utils.timing import COUNTERS
    except ImportError:
        return None
    if not COUNTERS.get("proves") or "uploads" not in COUNTERS:
        return None
    return COUNTERS["uploads"] / COUNTERS["proves"]
