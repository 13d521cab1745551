"""The program under test, ``zkodst_tpu_torch``, behind the few calls the
harness makes: set-up through the port's normal entry
(``api.setup_blake2f``), its launch counters, the profiler trace and the
MSM probe around its proves, and its outputs as the reference reads
them."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from zkodst_tpu_torch import api, kernels
from zkodst_tpu_torch.kernels import build
from zkodst_tpu_torch.ops import msm

from . import probes
from . import trace as trace_mod
from .roofline import peaks


class Port:
    def __init__(self, control: Optional[str] = None):
        self.rounds = None
        if control is not None:
            key, _, value = control.partition("=")
            if key != "rounds":
                raise ValueError(f"unknown control {control!r}")
            self.rounds = int(value)

    @staticmethod
    def prepare() -> None:
        """Build the kernel libraries (nvcc, in a checkout's first run). The
        clients of a cell call it in turn under one lock, so the first
        builds and the others only load that build."""
        build.build()

    def setup(self, cfg: Dict, n_inst: int, device: str):
        """The pipeline as the configuration states it (the control: with
        another number of rounds): the kernel libraries loaded (built by
        nvcc in a checkout's first run), then the SRS or the IPA
        generators made in this process, and keygen, with no cache."""
        build.build()
        return api.setup_blake2f(
            k=cfg["k"], n_inst=n_inst,
            rounds=cfg["rounds"] if self.rounds is None else self.rounds,
            srs_seed=cfg.get("srs_seed", 0), cache_dir=None, echo=False,
            scheme=cfg["scheme"], device=device)

    @staticmethod
    def synchronize() -> None:
        torch.cuda.synchronize()

    @staticmethod
    def card():
        return peaks.card()

    @staticmethod
    def phase_spans(prover):
        return probes.phase_spans(prover.metrics)

    @staticmethod
    def launches() -> Dict[str, int]:
        return {**kernels.counts(), **kernels.blake2f_counts()}

    def trace(self, prove, proves: int, log) -> Dict:
        return trace_mod.trace_proves(prove, proves, self.launches,
                                      kernels.reset_counts, log=log)

    def trace_until(self, prove, arm) -> Dict:
        """This process's share of a trace of several clients' proves."""
        return trace_mod.trace_until(prove, arm, self.launches,
                                     kernels.reset_counts)

    @staticmethod
    def msm_probe(prove, proves: int) -> Optional[Dict]:
        """The MSM layer's time and the frozen model's work over `proves`
        proves (the scalars counted after each prove)."""
        total = {"time_s": 0.0, "ops": 0, "bytes": 0, "least_s": 0.0,
                 "calls": 0}
        peak = peaks.card()
        with probes.MsmProbe(msm) as probe:
            for j in range(proves):
                prove(j)
                seconds, ops, nbytes, per_call = probe.drain()
                total["time_s"] += seconds
                total["ops"] += ops
                total["bytes"] += nbytes
                total["calls"] += len(per_call)
                if peak is not None:
                    total["least_s"] += sum(peaks.least_seconds(o, b, peak)
                                            for o, b in per_call)
        total["proves"] = proves
        total["peak"] = peak
        return total

    @staticmethod
    def keep_pub(inst):
        return inst["pub"].clone()

    @staticmethod
    def pub_words(pub) -> np.ndarray:
        """The program's (n, 2) (lo, hi) public column as n uint64 words."""
        w = pub.cpu().numpy().astype(np.uint64)
        return (w[:, 0] & np.uint64(0xFFFFFFFF)) | (w[:, 1] << np.uint64(32))

    @staticmethod
    def memory_peak() -> int:
        return int(torch.cuda.max_memory_allocated())

    @staticmethod
    def key(prover) -> Dict:
        vk = prover.pk.vk
        return {"fixed": dict(vk.fixed_commitments),
                "sigma": list(vk.sigma_commitments)}

    @staticmethod
    def release() -> None:
        torch.cuda.empty_cache()
