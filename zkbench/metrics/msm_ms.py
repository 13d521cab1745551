"""msm_ms: the MSM layer (every program span whose label ends in
``.msm``: one for each outermost call of ``ops.msm.msm_many`` /
``msm_many_mont``, from its open to the card's completion of its work),
summed over a prove, mean ms a prove over the window. None where the
program has no such span. Moves prove_throughput."""


def read(ctx):
    per = [sum(v for k, v in ph.items() if k.endswith(".msm"))
           for ph in ctx["run"].window_phases
           if any(k.endswith(".msm") for k in ph)]
    return 1e3 * sum(per) / len(per) if per else None
