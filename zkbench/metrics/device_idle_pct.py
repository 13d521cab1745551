"""device_idle_pct: 1 − (the union of the device's kernel, copy and fill
intervals ÷ the traced window of steady proves), in %; in a cell of
several clients, the union of every client process's intervals in their
common traced window (``trace.merge``). None when the profiler's kernel
records still differ from the program's launch counts after the
retakes: a trace with holes is not read. Moves prove_throughput."""


def read(ctx):
    tr = ctx["run"].trace
    if not tr or tr["lost"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
