"""One run of one cell: set-up, warm-up, a closed-loop window of proves,
the reference's check of a sample of them, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` (a ``read(ctx)`` that returns the number, or None
where the run gave it nothing to read) under the benchmark's folder.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib.util
import json
import os
import random
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import traffic as traffic_mod
from .reference import check

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "zkodst_tpu")
TRACED_PROVES = 3               # proves in the profiler's window
MSM_PROVES = 2                  # proves timed by the MSM probe
REFERENCE_SAMPLE = {"kzg": 8, "ipa": 4}


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def since_process_start() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_reader(bench_root: str, name: str) -> Callable:
    path = os.path.join(bench_root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"zkbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``zkodst_tpu_torch`` is not ``zkodst_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def blind_seed(seed: int, stream: int, i: int) -> int:
    d = hashlib.blake2b(f"{seed}:{stream}:{i}".encode(), digest_size=8)
    return int.from_bytes(d.digest(), "little")


def throughput(instances: int, seconds: float) -> float:
    return instances / seconds


def p90(latencies: List[float]) -> float:
    return statistics.quantiles(latencies, n=10, method="inclusive")[8]


@dataclass
class Cell:
    name: str
    bench_root: str
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def cell_of(manifest: Dict, workload: str, bench_root: str) -> Cell:
    wl = next((w for w in manifest["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == wl["config"])
    config = load_json(os.path.join(bench_root, "configs",
                                    f"{cfg_entry['name']}.json"))

    def here(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in manifest["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if here(m) and m["moves"] in reported]
    return Cell(workload, bench_root, config,
                traffic_mod.load(bench_root, wl["traffic"]), e2e, layer)


@dataclass
class Run:
    """What a run gathered, for the result line and the metric readers."""

    latencies: List[float] = field(default_factory=list)
    window_s: float = 0.0
    instances: int = 0
    errors: int = 0
    setup_s: float = 0.0
    setup_split: Dict[str, float] = field(default_factory=dict)
    check_s: float = 0.0
    setup_phases: Dict[str, float] = field(default_factory=dict)
    window_phases: List[Dict[str, float]] = field(default_factory=list)
    launches: Optional[Dict] = None
    trace: Optional[Dict] = None
    msm: Optional[Dict] = None
    card: Optional[Dict] = None

    def phase_mean_ms(self, labels: List[str]) -> Optional[float]:
        """The mean over the window's proves of the summed seconds of these
        prover phases (host clock; the program synchronizes at each
        phase's end), in ms; None when no prove ran them all."""
        per = [sum(ph[lb] for lb in labels) for ph in self.window_phases
               if all(lb in ph for lb in labels)]
        return 1e3 * sum(per) / len(per) if per else None


def _phases_of(metrics, since: int) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for ph in metrics.phases[since:]:
        out[ph.label] = out.get(ph.label, 0.0) + ph.seconds
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             system, device: str, marks: Optional[Dict] = None) -> Dict:
    """The run: returns the result line's object (without device facts
    that only the card gives). `system` is the program under test
    (:class:`.system.Port` on the card; tests pass a stand-in); `marks`
    the seconds the interpreter's start, torch's import, the program's
    import and the CUDA context took, for the set-up's split."""
    cfg, spec = cell.config, cell.traffic
    n_inst = spec["instances_per_proof"]
    run = Run()
    t_setup = since_process_start()
    prover = system.setup(cfg, n_inst, device)
    t_built = since_process_start()
    run.setup_phases = _phases_of(prover.metrics, 0)

    def prove(stream: int, i: int):
        b = traffic_mod.batch(spec, seed, stream, i)
        return b, prover.prove(*b.pairs(), seed=blind_seed(seed, stream, i))

    for i in range(spec["warmup_proves"]):
        prove(traffic_mod.WARMUP, i)
    system.synchronize()
    run.setup_s = since_process_start()
    params_keygen = run.setup_phases.get("setup", 0.0)
    keygen = run.setup_phases.get("setup.keygen", 0.0)
    run.setup_split = {
        **(marks or {}),
        "kernels_load": t_built - t_setup - params_keygen,
        "params": params_keygen - keygen, "keygen": keygen,
        "warmup": run.setup_s - t_built}
    extra = spec["warmup_proves"]        # later set-up proves' batch index

    if trace:
        run.card = system.card()
        with system.phase_spans(prover):
            run.trace = system.trace(
                lambda j: prove(traffic_mod.WARMUP, extra + j),
                TRACED_PROVES, log)
        extra += TRACED_PROVES * 3
        run.launches = {"counts": run.trace["counted"],
                        "proves": TRACED_PROVES}
        run.msm = system.msm_probe(
            lambda j: prove(traffic_mod.WARMUP, extra + j), MSM_PROVES)

    k = REFERENCE_SAMPLE[cfg["scheme"]]
    rng = random.Random(seed)
    samples: List = []
    metrics = prover.metrics
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    i = proved = 0
    while time.perf_counter() < deadline:
        before = len(metrics.phases)
        b = traffic_mod.batch(spec, seed, traffic_mod.WINDOW, i)
        pairs = b.pairs()
        t0 = time.perf_counter()
        try:
            proof, inst = prover.prove(*pairs, seed=blind_seed(
                seed, traffic_mod.WINDOW, i))
        except Exception as ex:        # the window goes on; counted
            log(f"prove {i} raised {type(ex).__name__}: {ex}")
            run.errors += 1
            proof = inst = None
        t_end = time.perf_counter()
        run.latencies.append(t_end - t0)
        run.window_phases.append(_phases_of(metrics, before))
        if proof is not None:
            run.instances += n_inst
            # a reservoir sample of the window's proofs, drawn from the seed
            slot = len(samples) if len(samples) < k \
                else rng.randrange(proved + 1)
            if slot < k:
                kept = check.Sample(i, b.h, b.m, b.t, b.f, proof,
                                    system.keep_pub(inst))
                if slot == len(samples):
                    samples.append(kept)
                else:
                    samples[slot] = kept
            proved += 1
        i += 1
    run.window_s = t_end - t_start
    q = statistics.quantiles(run.latencies, n=4) if len(run.latencies) > 1 \
        else [0, 0, 0]
    log(f"latency min {min(run.latencies):.4f} q1 {q[0]:.4f} median "
        f"{q[1]:.4f} q3 {q[2]:.4f} max {max(run.latencies):.4f}")
    memory_peak = system.memory_peak()
    program_key = system.key(prover)
    del prover
    gc.collect()
    system.release()

    samples.sort(key=lambda s: s.index)
    for s in samples:
        s.pub = system.pub_words(s.pub)
    t_check = time.perf_counter()
    numbers = check.judge(cfg, n_inst, samples, program_key, run.errors,
                          seed, log=log)
    run.check_s = time.perf_counter() - t_check
    failed = run.errors + numbers["proofs_rejected"]
    metrics_out = read_metrics(cell, run, trace)
    return {"correct": check.verdict(numbers) and bool(run.latencies),
            "attempted": len(run.latencies), "failed": failed,
            "metrics": metrics_out, "memory_peak_bytes": memory_peak,
            "run": run, "checks": numbers, "sampled": len(samples)}


def read_metrics(cell: Cell, run: Run, trace: bool) -> Dict:
    out = {}
    if not trace:
        values = {"prove_throughput": throughput(run.instances,
                                                 run.window_s),
                  "prove_p90_s": p90(run.latencies) if len(run.latencies)
                  > 1 else None,
                  "setup_s": run.setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                out[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        return out
    ctx = {"run": run, "cell": cell}
    for m in cell.per_layer:
        v = load_reader(cell.bench_root, m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def checks_line(numbers: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    return {k: {"value": v, "limit": check.LIMITS[k]}
            for k, v in numbers.items()}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="run the control instead of the program as the "
                         "configuration states it: rounds=<r> proves "
                         "with another number of rounds")
    return ap.parse_args(argv)


def main(argv, repo_root: str) -> int:
    args = parse(argv)
    marks = {"interpreter": since_process_start()}
    cache = os.path.join(repo_root, ".zkbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(cache, "nv"))
    import torch

    marks["torch_import"] = since_process_start() - marks["interpreter"]
    manifest = load_json(os.path.join(repo_root, "BENCHMARK.json"))
    wl = next((w for w in manifest["workloads"]
               if w["name"] == args.workload), None)
    if wl is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        log(f"the cell needs {wl['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found: no run without the card")
        return 2
    t = since_process_start()
    try:
        from . import system as system_mod
        system = system_mod.Port(control=args.control)
    except ImportError as ex:
        log(f"the program under test cannot be imported: {ex}")
        return 4
    marks["program_import"] = since_process_start() - t
    cell = cell_of(manifest, args.workload, HERE)
    t = since_process_start()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda_context"] = since_process_start() - t
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), system,
                   "cuda", marks)
    leaked = forbidden_modules()
    if leaked:
        log(f"modules of the JAX package or JAX are loaded: {leaked}")
        return 3
    run = out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": wl["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace:
        tr = run.trace
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
        line["card"] = run.card
    if args.control:
        line["control"] = args.control
    line["setup_split"] = run.setup_split
    line["check_s"] = run.check_s
    line["checks"] = checks_line(out["checks"])
    log(f"set-up {run.setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_split.items()))
    log(f"window: {out['attempted']} proves in {run.window_s:.3f} s, "
        f"{out['sampled']} checked by the reference in {run.check_s:.1f} s")
    for k, v in line["checks"].items():
        log(f"check {k} = {v['value']} (limit {v['limit']})")
    print(json.dumps(line), flush=True)
    return 0
