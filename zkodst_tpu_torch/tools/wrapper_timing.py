"""Host and device time of the BLAKE2f kernels' wrappers (kernels 13 and
14) in the checkout it is run from, on a CUDA card; one JSON line with the
card's name and power limit.

    python3 -m zkodst_tpu_torch.tools.wrapper_timing [calls]

- ``compress_host_us``: host µs per ``blake2f_compress`` call at the
  ``bench`` command's line-1 batch (8192 EIP-152 compressions,
  ``bench.eip152_batch``), median of five loops of `calls` calls; each
  loop's launches wait behind a spin kernel, so the host neither waits
  for the card nor shares it, and the kernel is not in the time.
- ``compress_device_us``: device µs per call (CUDA events around `calls`
  calls queued behind a spin kernel); ``compress_kernel_us``: the kernel
  alone, from a ``torch.profiler`` trace of `calls` calls.
- ``line1``: the ``bench`` command's line 1 (``bench.bench_witness``).
- ``advice_device_us`` / ``advice_kernel_us``: ``blake2f_advice`` at the
  flagship's size (37 instances, 12 rounds, the circuit's placement), its
  memset and kernel by CUDA events as above, and the kernel alone from a
  ``torch.profiler`` trace of `calls` calls; ``stream_device_us`` /
  ``stream_kernel_us``: the stream form (``blake2f_witness``) at that
  size. A kernel time the trace did not record is null.
- ``witness_wall_us``: wall µs per ``Blake2fCircuit.witness`` at the
  flagship's 37 instances and 12 rounds, synchronised after each call
  (its inputs' copy to the card waits for the card, so no spin can hide
  the kernel there), the median of 10.

To compare two checkouts on one card, run it in turns (parent, change,
change, parent) from each root with that checkout first on the path:

    PYTHONPATH=. python3 <this checkout>/zkodst_tpu_torch/tools/wrapper_timing.py
"""

from __future__ import annotations

import json
import statistics
import sys
import time

SPIN_CYCLES_PER_CALL = 1_000_000     # ~0.5 ms of card time a queued call


def host_us(fn, calls: int, loops: int = 5) -> float:
    """Host µs per call of `fn`: the median of `loops` loops of `calls`
    calls, each loop queued behind a spin kernel long enough to outlast
    it, the card synchronised after each loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(loops):
        torch.cuda._sleep(SPIN_CYCLES_PER_CALL * calls)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def device_us(fn, calls: int) -> float:
    """Device µs per call: CUDA events around `calls` calls queued behind a
    spin kernel, so the host's time between launches opens no gap."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * calls)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / calls


def kernel_us(fn, calls: int, name: str) -> float:
    """Device µs per call of the kernels whose trace name holds `name`,
    from a ``torch.profiler`` trace of `calls` calls, or None where the
    trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0)
             for ev in prof.key_averages() if name in ev.key) / calls
    return us or None


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("wrapper_timing: CUDA is not available", file=sys.stderr)
        return 1
    from zkodst_tpu_torch import api, bench
    from zkodst_tpu_torch.circuit.blake2f import Blake2fCircuit
    from zkodst_tpu_torch.kernels import blake2 as kb

    calls = int(argv[0]) if argv else 50
    dev = torch.device("cuda", 0)
    h, m, t, f = bench.eip152_batch(dev, 8192)
    out = {"card": bench.card(dev)}

    def compress():
        return kb.blake2f_compress(h, m, t, f, 12)

    out["compress_host_us"] = host_us(compress, calls)
    out["compress_device_us"] = device_us(compress, calls)
    out["compress_kernel_us"] = kernel_us(compress, calls, "blake2f_compress")
    out["line1"], _ = bench.bench_witness(dev)
    circ = Blake2fCircuit(k=17, n_inst=37, rounds=12, device=dev)
    inputs = api.eip152_inputs(37)
    if hasattr(kb, "blake2f_advice"):
        words = [torch.as_tensor(x.astype("int64"), device=dev)
                 for x in inputs]

        def advice():
            return kb.blake2f_advice(*words, 12, circ.plan)

        def stream():
            return kb.blake2f_witness(*words, 12)

        out["advice_device_us"] = device_us(advice, calls)
        out["advice_kernel_us"] = kernel_us(advice, calls, "blake2f_place")
        out["stream_device_us"] = device_us(stream, calls)
        out["stream_kernel_us"] = kernel_us(stream, calls, "blake2f_place")

    def witness():
        return circ.witness(*inputs)

    witness()
    wall = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        witness()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e6)
    out["witness_wall_us"] = statistics.median(wall)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
