"""The card's peaks, against which the roofline shares are stated.

* 32-bit integer multiplies: SMs × 64 a clock × the SM's maximum clock
  (Hopper issues 64 IMAD results per SM per clock), both read from the
  card, stated beside its power limit;
* memory: the H100 SXM's published 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_SM_PER_CLOCK = 64


def card() -> Optional[Dict]:
    """{name, sms, sm_clock_max_mhz, power_limit_w, mul32_per_s}, read by
    nvidia-smi and torch; None where either cannot be read."""
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        name, clock, power = (x.strip() for x in
                              out.stdout.splitlines()[0].split(","))
        clock_hz = float(clock) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"name": name, "sms": sms, "sm_clock_max_mhz": float(clock),
            "power_limit_w": power,
            "mul32_per_s": sms * IMAD_PER_SM_PER_CLOCK * clock_hz,
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def least_seconds(ops: float, nbytes: float, peak: Dict) -> float:
    """The larger of the compute and the memory bound."""
    return max(ops / peak["mul32_per_s"], nbytes / peak["hbm_bytes_per_s"])
