"""msm_roofline_pct: the MSM layer's least time under the frozen work
model (``roofline/msm.py``: the larger of its 32-bit multiplies at the
card's peak and its bytes at 3.35 TB/s, call by call) as a share of the
time the layer took (CUDA events around each outermost call of
``ops.msm.msm_many`` / ``msm_many_mont``), over the probed proves. None
where the card's peak could not be read. Moves prove_throughput."""


def read(ctx):
    m = ctx["run"].msm
    if not m or m.get("peak") is None or not m["time_s"]:
        return None
    return 100.0 * m["least_s"] / m["time_s"]
