"""The one traffic generator: reads a mix's parameters (a JSON file under
``traffic/``) and makes each proof's batch of EIP-152 compressions from
the run's seed.

A mix file holds::

    {"loop": "closed", "clients": 1, "warmup_proves": 2,
     "instances_per_proof": 37,
     "words": {"h": {"dist": "uniform"}, "m": {"dist": "uniform"},
               "t0": {"dist": "uniform"}, "t1": {"dist": "const", "value": 0},
               "f": {"dist": "bernoulli", "p": 0.5}}}

``uniform`` draws 64-bit words, ``const`` repeats ``value`` (an int, or a
list with one int per word of the field), ``bernoulli`` draws the final
flag. ``clients`` closed-loop clients send at once, each its own stream
of proofs; ``warmup_proves`` is each client's. Batch i of a client of a
run depends on (seed, stream, i, client) alone, so every seed gives the
same sizes and the same number of words, in other values; client 0 draws
what a one-client run draws.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

WORDS = {"h": 8, "m": 16, "t0": 1, "t1": 1, "f": 1}
WARMUP, WINDOW = 0, 1           # the two streams of a run's batches


@dataclass
class Batch:
    """One proof's compressions as uint64 words: h (B, 8), m (B, 16),
    t (B, 2) and f (B,) bool."""

    h: np.ndarray
    m: np.ndarray
    t: np.ndarray
    f: np.ndarray

    def pairs(self):
        """(h, m, t, f) with every word as a (lo, hi) pair of 32-bit
        halves, the prover's input layout."""
        def split(w):
            return np.stack([w & np.uint64(0xFFFFFFFF),
                             w >> np.uint64(32)], -1).astype(np.int64)
        return split(self.h), split(self.m), split(self.t), self.f.copy()


def load(root: str, name: str) -> Dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as fh:
        spec = json.load(fh)
    if spec.get("loop") != "closed":
        raise ValueError(f"traffic {name}: an open loop is not generated "
                         "yet; only a closed loop")
    clients = spec.get("clients")
    if not isinstance(clients, int) or clients < 1:
        raise ValueError(f"traffic {name}: clients must be a whole number "
                         f"of at least 1, not {clients!r}")
    unknown = set(spec["words"]) ^ set(WORDS)
    if unknown:
        raise ValueError(f"traffic {name}: words {sorted(unknown)}")
    return spec


def _draw(rng, rule: Dict, shape):
    dist = rule["dist"]
    if dist == "uniform":
        return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    if dist == "const":
        v = np.asarray(rule["value"], dtype=np.uint64)
        return np.broadcast_to(v, shape).copy()
    raise ValueError(f"unknown distribution {dist!r}")


def batch(spec: Dict, seed: int, stream: int, i: int,
          client: int = 0) -> Batch:
    """Batch i of a stream (WARMUP or WINDOW) of `client` in the run of
    `seed`."""
    key = [seed % (1 << 64), stream, i] + ([client] if client else [])
    rng = np.random.default_rng(key)
    b = spec["instances_per_proof"]
    w = spec["words"]
    h = _draw(rng, w["h"], (b, 8))
    m = _draw(rng, w["m"], (b, 16))
    t = np.concatenate([_draw(rng, w["t0"], (b, 1)),
                        _draw(rng, w["t1"], (b, 1))], 1)
    frule = w["f"]
    if frule["dist"] == "bernoulli":
        f = rng.random(b) < frule["p"]
    else:
        f = _draw(rng, frule, (b,)).astype(bool)
    return Batch(h, m, t, f)
