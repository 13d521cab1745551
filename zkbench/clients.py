"""A cell of several closed-loop clients on one card: each client is a
prover process of its own, as a proving service runs N workers a card.

The parent starts the clients with the ``spawn`` method before anything
else, and checks the card while they start. Each client builds the
program under test from an importable :class:`Factory`, has the kernel
libraries built under a lock of the checkout (so only the first client
of a checkout's first run builds them, and the others load that build),
does the set-up and warm-up every run does (:func:`.harness.set_up`) and
reports ready: the barrier. The parent then sends every client one
common start and deadline (``time.perf_counter``, CLOCK_MONOTONIC, one
clock for every process of the machine): where the run is traced, first
for a traced window, once every client has started its profiler, then
for the MSM probe's proves at once; then for the measured window. Each
client answers with what it measured, its own spans and counters and a
sample of its proofs, frees its state and ends. The parent pools the
answers (:func:`run_clients`), so that every per-layer reader reads all
the clients, and has the reference judge a sample drawn from every
client's.

A client that raises or dies, or does not answer within its timeout, ends
the run with :class:`ClientFailed`; every client is stopped before the
parent returns.
"""

from __future__ import annotations

import contextlib
import fcntl
import gc
import importlib
import multiprocessing
import os
from multiprocessing import resource_tracker
import queue
import random
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

from . import harness
from . import trace as trace_mod
from . import traffic as traffic_mod
from .harness import log
from .reference import check
from .roofline import ntt as ntt_model

SETUP_TIMEOUT_S = 600.0     # a client's start, set-up and warm-up proves
TRACE_TIMEOUT_S = 180.0     # one traced window, its export and reduction
WINDOW_GRACE_S = 120.0      # past the deadline: the last prove, the release
JOIN_TIMEOUT_S = 30.0
WINDOW_MARGIN_S = 0.1       # from the command to the window's start
TRACE_MARGIN_S = 0.1        # from the command to the traced window's start
TRACE_SECONDS = 1.0         # the traced window: ~4 proves a client
TRACE_TRIES = 3


class ClientFailed(RuntimeError):
    """A client raised, died or timed out: the run has no result."""


@dataclass(frozen=True)
class Factory:
    """The program under test as an importable class and its arguments, so
    that a spawned client can build it."""

    module: str
    name: str
    kwargs: Dict = field(default_factory=dict)

    def make(self):
        cls = getattr(importlib.import_module(self.module), self.name)
        return cls(**self.kwargs)


@dataclass
class Job:
    """What a client is given."""

    client: int
    clients: int
    cell: harness.Cell
    seed: int
    factory: Factory
    device: str
    trace: bool
    build_lock: str


def _wait_until(t: float) -> None:
    while time.perf_counter() < t:
        time.sleep(min(0.001, max(0.0, t - time.perf_counter())))


def _client(job: Job, commands, results) -> None:
    """A client process's body: every failure is reported, then raised."""
    try:
        _serve(job, commands, results)
    except BaseException:
        results.put(("error", job.client, traceback.format_exc()))
        raise


@contextlib.contextmanager
def _locked(path: str):
    """Hold an exclusive lock on the file `path` (made if need be)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _serve(job: Job, commands, results) -> None:
    c = job.client
    started = harness.since_process_start()
    system = job.factory.make()
    t_made = harness.since_process_start()
    with _locked(job.build_lock):
        system.prepare()
    t_built = harness.since_process_start()
    su = harness.set_up(system, job.cell, job.seed, job.device, c)
    prover, prove = su.prover, su.prove
    results.put(("ready", c, {
        "split": {"start": started, "program_import": t_made - started,
                  "kernels_build": t_built - t_made, **su.split},
        "phases": su.phases,
        "card": system.card() if job.trace else None}))
    extra = job.cell.traffic["warmup_proves"]   # later set-up proves' index

    def arm():
        """Report the profiler started; take the common window."""
        results.put(("armed", c, None))
        return _command(commands, "go")

    while True:
        cmd, start, until = commands.get(timeout=SETUP_TIMEOUT_S)
        if cmd == "trace":
            with system.phase_spans(prover):
                tr = system.trace_until(
                    lambda j: prove(traffic_mod.WARMUP, extra + j), arm)
            extra += tr["proves"]
            results.put(("trace", c, tr))
        elif cmd == "msm":
            msm = system.msm_probe(
                lambda j: prove(traffic_mod.WARMUP, extra + j),
                harness.MSM_PROVES)
            extra += harness.MSM_PROVES
            results.put(("msm", c, msm))
        else:
            out = _window(job, system, prover, start, until)
            del prover, prove, su
            gc.collect()
            system.release()
            out["leaked"] = harness.forbidden_modules()
            results.put(("window", c, out))
            return


def _command(commands, want: str):
    cmd, start, until = commands.get(timeout=TRACE_TIMEOUT_S)
    if cmd != want:
        raise RuntimeError(f"command {cmd!r} where {want!r} was due")
    return start, until


def _window(job: Job, system, prover, start: float, deadline: float) -> Dict:
    """The measured window of one client from `start`, with a reservoir
    sample of its proofs drawn from (seed, client)."""
    c, seed = job.client, job.seed
    sample = harness.Reservoir(
        harness.REFERENCE_SAMPLE[job.cell.config["scheme"]],
        random.Random(f"{seed}:{c}"))
    _wait_until(start)
    out = harness.closed_loop(system, prover, job.cell.traffic, seed,
                              deadline, sample, c, job.clients)
    out["samples"] = sorted(sample.items, key=lambda s: s.index)
    for s in out["samples"]:
        s.pub = system.pub_words(s.pub)
    out.update(key=system.key(prover), memory_peak=system.memory_peak())
    out["counters"], out["ntt_proves"] = _readings(len(out["latencies"])) \
        if job.trace else (None, None)
    return out


class NttSpan(NamedTuple):
    """What the NTT readers read of one of the program's ``.ntt`` spans,
    sent to the parent without the program's own types."""

    label: str
    device_s: Optional[float]
    counts: Optional[Dict[str, int]]


def _readings(proves: int):
    """This client's program counters (``utils.timing.COUNTERS``) and the
    ``.ntt`` spans of its newest `proves` proves, each None where the
    program keeps none."""
    spans = ntt_model.window_proves(proves)
    if spans is not None:
        spans = [[NttSpan(sp.label, sp.device_s, sp.counts) for sp in p]
                 for p in spans]
    try:
        from zkodst_tpu_torch.utils.timing import COUNTERS
    except ImportError:
        return None, spans
    return dict(COUNTERS), spans


def _gather(results, procs, tag: str, timeout: float) -> List:
    """Each client's answer `tag`, in client order; ClientFailed where a
    client reports an error, ends without answering, or the time runs
    out."""
    got: Dict[int, object] = {}
    end = time.monotonic() + timeout
    while len(got) < len(procs):
        try:
            kind, c, payload = results.get(timeout=0.5)
        except queue.Empty:
            gone = [c for c, p in enumerate(procs)
                    if c not in got and not p.is_alive()]
            if not gone and time.monotonic() < end:
                continue
            try:                # a client's last answer may be in the pipe
                kind, c, payload = results.get(timeout=2.0)
            except queue.Empty:
                if gone:
                    codes = [procs[g].exitcode for g in gone]
                    raise ClientFailed(
                        f"client(s) {gone} ended with exit code(s) {codes} "
                        f"before {tag!r}") from None
                missing = sorted(set(range(len(procs))) - set(got))
                raise ClientFailed(f"no {tag!r} from client(s) {missing} "
                                   f"within {timeout:.0f} s") from None
        if kind == "error":
            raise ClientFailed(f"client {c} raised:\n{payload}")
        if kind != tag:
            raise ClientFailed(f"client {c} answered {kind!r}, not {tag!r}")
        got[c] = payload
    return [got[c] for c in range(len(procs))]


def _stop(procs, queues) -> None:
    """End every client still running and close the queues."""
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)
    for q in queues:
        q.close()
        q.join_thread()


def choose(per_client: List[List[check.Sample]], k: int,
           seed: int) -> List[check.Sample]:
    """`k` of the clients' sampled proofs (more where there are more
    clients), drawn from the seed: one from each client that has one,
    the rest from all that are left."""
    rng = random.Random(seed)
    chosen = [rng.choice(s) for s in per_client if s]
    rest = [x for s in per_client for x in s
            if all(x is not y for y in chosen)]
    chosen += rng.sample(rest, max(0, min(k - len(chosen), len(rest))))
    return sorted(chosen, key=lambda s: s.index)


def run_clients(cell: harness.Cell, seed: int, seconds: float, trace: bool,
                factories: List[Factory], device: str, build_lock: str,
                marks: Optional[Dict] = None,
                card: Optional[Callable[[], object]] = None) -> Dict:
    """The run of a cell of len(`factories`) clients, one process each:
    returns what :func:`harness.run_cell` returns. `build_lock` is the
    file under whose lock each client has the kernel libraries built;
    `card` the parent's check of the card, run once the clients have
    started (it raises :class:`.harness.NoCard` where the card is
    missing). The resource tracker that the ``spawn`` method starts is
    ended and waited for once the clients' queues are gone."""
    failed = None
    try:
        out = _run_clients(cell, seed, seconds, trace, factories, device,
                           build_lock, marks, card)
    except (ClientFailed, harness.NoCard) as ex:
        failed = (type(ex), str(ex))    # its traceback would keep the queues
    gc.collect()                # the queues' semaphores leave the tracker
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    if failed is not None:
        raise failed[0](failed[1])
    return out


def _summed(parts: List[Optional[Dict]]) -> Optional[Dict]:
    """The clients' readings summed key by key (a dict's non-numeric
    values: client 0's); None where a client has none."""
    if not parts or any(p is None for p in parts):
        return None
    return {k: sum(p[k] for p in parts)
            if isinstance(v, (int, float)) else v
            for k, v in parts[0].items()}


def _mean_phases(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """The set-up's phases as the clients' mean, for the phases all have."""
    common = set(parts[0]).intersection(*parts[1:])
    return {k: sum(p[k] for p in parts) / len(parts) for k in common}


def _run_clients(cell, seed, seconds, trace, factories, device, build_lock,
                 marks, card) -> Dict:
    cfg, spec = cell.config, cell.traffic
    n = len(factories)
    run = harness.Run()
    t_spawn = harness.since_process_start()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    commands = [ctx.Queue() for _ in range(n)]
    procs = [ctx.Process(target=_client, name=f"zkbench-client-{c}",
                         args=(Job(c, n, cell, seed, factories[c], device,
                                   trace, build_lock), commands[c], results))
             for c in range(n)]

    def everyone(cmd, start=None, until=None):
        for q in commands:
            q.put((cmd, start, until))

    try:
        for p in procs:
            p.start()
        if card is not None:
            card()
        ready = _gather(results, procs, "ready", SETUP_TIMEOUT_S)
        run.setup_s = harness.since_process_start()
        run.setup_phases = _mean_phases([r["phases"] for r in ready])
        run.setup_split = {**(marks or {}),
                           "clients_ready": run.setup_s - t_spawn}
        for c, r in enumerate(ready):
            log(f"client {c} set-up: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["split"].items()))
        if trace:
            run.card = ready[0]["card"]
            for attempt in range(TRACE_TRIES):
                everyone("trace")
                _gather(results, procs, "armed", TRACE_TIMEOUT_S)
                start = time.perf_counter() + TRACE_MARGIN_S
                everyone("go", start, start + TRACE_SECONDS)
                run.trace = trace_mod.merge(
                    _gather(results, procs, "trace", TRACE_TIMEOUT_S))
                run.trace["retakes"] = attempt
                if not run.trace["lost"]:
                    break
                log(f"trace {attempt + 1}: the profiler's kernel records "
                    f"differ from the launch counts by {run.trace['lost']}; "
                    "taking it again")
            run.launches = {"counts": run.trace["counted"],
                            "proves": run.trace["proves"]}
            everyone("msm")
            run.msm = _summed(_gather(results, procs, "msm",
                                      TRACE_TIMEOUT_S))
        start = time.perf_counter() + WINDOW_MARGIN_S
        everyone("window", start, start + seconds)
        outs = _gather(results, procs, "window",
                       WINDOW_MARGIN_S + seconds + WINDOW_GRACE_S)
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [c for c, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise ClientFailed(f"client(s) {alive} did not end")
    finally:
        _stop(procs, [results, *commands])

    k = harness.REFERENCE_SAMPLE[cfg["scheme"]]
    samples = choose([o["samples"] for o in outs], k, seed)
    for c, o in enumerate(outs):
        run.latencies += o["latencies"]
        run.window_phases += o["phases"]
        run.instances += o["instances"]
        run.errors += o["errors"]
        run.clients.append({
            "proves": len(o["latencies"]), "instances": o["instances"],
            "first": o["first"], "last": o["last"],
            "memory_peak": o["memory_peak"],
            "judged": sum(s.index % n == c for s in samples)})
        log(f"client {c}: " + ", ".join(
            f"{key} {v}" for key, v in run.clients[-1].items()))
    run.counters = _summed([o["counters"] for o in outs])
    if all(o["ntt_proves"] is not None for o in outs):
        run.ntt_proves = [p for o in outs for p in o["ntt_proves"]]
    firsts = [o["first"] for o in outs if o["first"] is not None]
    run.window_s = max(o["last"] for o in outs if o["last"] is not None) \
        - min(firsts) if firsts else 0.0
    t_check = time.perf_counter()
    numbers = check.judge(cfg, spec["instances_per_proof"], samples,
                          outs[0]["key"], run.errors, seed, log=log)
    run.check_s = time.perf_counter() - t_check
    numbers["key_points_differ"] = numbers.get("key_points_differ", 0) + sum(
        check.keys_differ(o["key"], outs[0]["key"], cfg) for o in outs[1:])
    numbers["clients_unjudged"] = sum(not c["judged"] for c in run.clients)
    return {"correct": check.verdict(numbers) and bool(run.latencies),
            "attempted": len(run.latencies),
            "failed": run.errors + numbers["proofs_rejected"],
            "metrics": harness.read_metrics(cell, run, trace),
            "memory_peak_bytes": sum(o["memory_peak"] for o in outs),
            "run": run, "checks": numbers, "sampled": len(samples),
            "leaked": sorted({m for o in outs for m in o["leaked"]})}
