"""Time the flagship main path of the checkout it is run from, on a CUDA
card: setup, one cold and N warm proves of the EIP-152 inputs (blind seed
2), and the verifier; one JSON line with the card's name and power limit.

    python3 -m zkodst_tpu_torch.tools.path_timing [kzg|ipa] [proves]

To compare two checkouts on one card, run it in turns (parent, change,
change, parent) from each checkout's root with that checkout first on the
path; the package it times is the one it imports:

    PYTHONPATH=. python3 <this checkout>/zkodst_tpu_torch/tools/path_timing.py ipa 5

Host clock around work that ends in ``torch.cuda.synchronize()``; the
proof's sha256 shows both made the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("path_timing: CUDA is not available", file=sys.stderr)
        return 1
    from zkodst_tpu_torch import api

    scheme = argv[0] if argv else "kzg"
    proves = int(argv[1]) if len(argv) > 1 else 5
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    inputs = api.eip152_inputs(37)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pr, setup_s = timed(lambda: api.setup_blake2f(
        k=17, n_inst=37, scheme=scheme, echo=False, device="cuda"))
    (proof, inst), cold_s = timed(lambda: pr.prove(*inputs, seed=2))
    warm = [timed(lambda: pr.prove(*inputs, seed=2))[1]
            for _ in range(proves)]
    ok, verify_s = timed(lambda: pr.verify(inst, proof))
    print(json.dumps({
        "card": card, "scheme": scheme, "setup_s": setup_s,
        "prove_cold_s": cold_s, "prove_warm_s": warm, "verify_s": verify_s,
        "verified": bool(ok), "proof_bytes": len(proof),
        "proof_sha256": hashlib.sha256(proof).hexdigest()}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
