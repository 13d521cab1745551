"""The port's spans and host-wait counters (``utils/timing.py``), and the
benchmark's readers of them (``zkbench/metrics/``).

CPU: a span tree's labels, parents and prove ids; the last prove's spans
as the CLI prints them; the span log's cap and its indices; a sub-span
with no span open does nothing; a nested close calls no ``torch.cuda.synchronize`` and
the outermost close one, and every CUDA event is released then (a
stand-in card); ``kernels.reset_counts()`` clears the counters; a copy
from the host counts as an upload up to ``timing.UPLOAD_MAX`` bytes and
as a wait above it; the staging ring's slots on a stand-in card; a toy
prove counts the same host waits and uploads each time, the pinned number
of its read, upload and mask sites, and its proofs' bytes are pinned; the
six readers on a stand-in run.

Card (``cuda``; skips without one): at k = 17 a warm KZG and a warm IPA
prove count as many host waits as the sync debug mode reports
synchronizing ops (plus the outermost span's wait), hold no CUDA event
once returned, and each phase's median over 30 warm proves lies within
10% (or 0.1 ms) of its median over 30 proves that synchronize at each
phase's end, in turns (a phase's time is bimodal from prove to prove);
a steady prove waits at most 45 (KZG) or 120 (IPA) times; 10 steady
proves allocate no pinned memory; uploads read at once by a kernel, and
the ring's slots reused, while a spin kernel holds the stream, give the
uploaded values. This file imports no JAX; on a card machine:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_spans.py``.
"""

import contextlib
import gc
import hashlib
import importlib.util
import json
import os
import statistics
import traceback
import warnings
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkbench.harness import Run
from zkodst_tpu_torch import kernels
from zkodst_tpu_torch.circuit.expr import V
from zkodst_tpu_torch.circuit.ir import CircuitDef, CopyGroup, Gate, Lookup
from zkodst_tpu_torch.ops import u64
from zkodst_tpu_torch.proof import keygen, prover, srs
from zkodst_tpu_torch.utils import timing
from zkodst_tpu_torch.utils.timing import Metrics, span

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, "tests", "golden", "dryrun_cache")
# host waits of one warm toy prove (k = 5, one lookup, no instance
# column): 11 reads back and the lookup sort's 4 boolean masks
TOY_WAITS = 15
# and its uploads: the constants, challenges, blinds and the lookup table
# (80), and the one of each batch inverse
TOY_UPLOADS = 84
# sha256 of the toy proofs of seeds 41, 42, 43
TOY_PROOFS = (
    "779c150130ef8be0fb2eae5d4debd7324ca3f5cfe675edeaaeffcc77d9fd3b07",
    "0457e650b88f8fe65bbb246abdf7e8ee933ff46f46c346212520979f11059c44",
    "518b4e431ed9cf4f6328cc4fdfbe8c02b22514e8169a705b36be466f6eaa3c6c")


@pytest.fixture(autouse=True)
def _fresh_counters():
    kernels.reset_counts()
    yield
    kernels.reset_counts()


def _tree(m: Metrics):
    with m.phase("prove"):
        with span("init"):
            pass
        with m.phase("prove.quotient"):
            with span("extend"):
                pass
            with span("msm", points=4, windows=2):
                pass
        with span("claims"):
            pass


def test_span_tree_labels_parents_and_prove_ids():
    m = Metrics(echo=False)
    _tree(m)
    _tree(m)
    got = [(p.label, p.parent) for p in m.phases[:6]]
    assert got == [("prove.init", "prove"),
                   ("prove.quotient.extend", "prove.quotient"),
                   ("prove.quotient.msm", "prove.quotient"),
                   ("prove.quotient", "prove"),
                   ("prove.claims", "prove"),
                   ("prove", None)]
    assert [p.label for p in m.phases[6:]] == [p.label for p in m.phases[:6]]
    first = {p.prove for p in m.phases[:6]}
    second = {p.prove for p in m.phases[6:]}
    assert len(first) == len(second) == 1 and first != second
    msm = m.phases[2]
    assert msm.counts == {"points": 4, "windows": 2}
    assert m.phases[1].counts is None
    assert all(p.seconds >= 0 and p.seconds == p.host_s
               and p.device_s is None for p in m.phases)  # no card
    assert timing.COUNTERS["proves"] == 2
    assert m.seconds("prove.quotient.extend") == m.phases[7].seconds


def test_tree_gives_the_last_prove_spans():
    m = Metrics(echo=False)
    assert m.tree() == []
    _tree(m)
    _tree(m)
    with m.phase("verify"):
        pass
    got = m.tree()
    assert [(d["label"], d["parent"]) for d in got] == \
        [(p.label, p.parent) for p in m.phases[6:12]]
    assert {d["prove"] for d in got} == {m.phases[11].prove}
    assert got[2]["counts"] == {"points": 4, "windows": 2}
    assert set(got[0]) == {"label", "seconds", "host_s", "device_s",
                           "parent", "prove", "launches", "waits", "counts"}
    assert [d["label"] for d in m.tree("verify")] == ["verify"]


def test_cli_prints_the_spans_before_the_proof_line(monkeypatch, capsys):
    from zkodst_tpu_torch import __main__ as tmain
    from zkodst_tpu_torch import api

    class Pipe:
        n_inst = 1
        metrics = Metrics(echo=False)

        def prove(self, *args, **kw):
            _tree(self.metrics)
            return b"\0" * 928, {}

        def verify(self, *args, **kw):
            return True

    monkeypatch.setattr(api, "setup_blake2f", lambda **kw: Pipe())
    assert tmain.main(["prove", "--device", "cpu", "--k", "5"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[-1] == {"proof_bytes": 928, "verified": True}
    assert [d["label"] for d in lines[-2]["prove_spans"]] == \
        [p.label for p in Pipe.metrics.phases]


def test_span_log_holds_the_newest_and_counts_every_span():
    log = timing.SpanLog(keep=4)
    for i in range(20):
        log.append(timing.Phase(str(i), 0.0))
    assert len(log) == 20
    assert [p.label for p in log[17:]] == ["17", "18", "19"]
    assert log[-1].label == "19" and log[15].label == "15"
    assert 4 <= len(list(log)) <= 8
    assert [p.label for p in reversed(log)][0] == "19"
    with pytest.raises(IndexError):
        log[0]
    assert log[0:2] == []
    m = Metrics(echo=False)
    assert isinstance(m.phases, timing.SpanLog)
    assert m.phases.keep == timing.KEEP_SPANS


def test_sub_span_without_an_open_span_does_nothing(capsys):
    m = Metrics()
    with span("orphan", points=3):
        with span("inner"):
            pass
    assert list(m.phases) == []
    assert timing.COUNTERS == {"host_waits": 0, "host_wait_s": 0.0,
                               "uploads": 0, "proves": 0}
    with m.phase("setup"):
        with span("params"):
            pass
    out = capsys.readouterr().out
    assert "Start: [setup]" in out and "params" not in out
    assert [p.label for p in m.phases] == ["setup.params", "setup"]


class _Event:
    """A stand-in CUDA event: records a time on the host's clock."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        _Event.clock[0] += 1e-3
        self.at = _Event.clock[0]

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def test_only_the_outermost_close_synchronizes(monkeypatch):
    syncs = []
    made = []

    class Event(_Event):
        def __init__(self, enable_timing=False):
            super().__init__()
            made.append(weakref.ref(self))

    monkeypatch.setattr(timing, "_on_card", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(query=lambda: True))
    m = Metrics(echo=False)
    with m.phase("prove"):
        with m.phase("prove.advice_commit"):
            with span("prep"):
                pass
            with span("msm"):
                pass
        assert syncs == []
        with span("claims"):
            pass
        assert syncs == []
    assert syncs == [1]
    assert timing.COUNTERS["host_waits"] == 1          # the anchor wait
    assert all(p.device_s is not None and p.device_s >= 0 for p in m.phases)
    assert all(p.seconds >= p.host_s for p in m.phases)
    assert m.phases[-1].waits == 1
    gc.collect()
    assert made and all(ref() is None for ref in made)


ZERO = {"host_waits": 0, "host_wait_s": 0.0, "uploads": 0, "proves": 0}


def test_reset_counts_clears_the_registry():
    timing.count_wait(0.0, 3)
    timing.COUNTERS["proves"] += 2
    timing.upload(torch.zeros(4), "cpu")
    with timing.host_wait(2):
        pass
    assert timing.COUNTERS["host_waits"] == 5
    assert timing.COUNTERS["uploads"] == 1
    kernels.reset_counts()
    assert timing.COUNTERS == ZERO


def test_reset_counters_clears_uploads():
    for _ in range(3):
        timing.upload(torch.zeros(4), "cpu")
    assert timing.COUNTERS["uploads"] == 3
    timing.reset_counters()
    assert timing.COUNTERS == ZERO


def test_reads_and_uploads_count_on_every_device():
    t = torch.arange(16, dtype=torch.int64).reshape(8, 2)
    u64.to_ints(t)
    u64.to_u32(t)
    timing.read(t)
    assert timing.COUNTERS["host_waits"] == 3     # reads wait
    assert torch.equal(timing.upload(t, "cpu"), t)
    assert timing.COUNTERS["host_waits"] == 3     # a small copy does not
    assert timing.COUNTERS["uploads"] == 1
    u64.to_ints(t.numpy())                  # host arrays: no wait
    assert timing.COUNTERS["host_waits"] == 3
    assert timing.COUNTERS["uploads"] == 1


@pytest.mark.parametrize("nbytes", [0, 8, 1 << 21, timing.UPLOAD_MAX,
                                    timing.UPLOAD_MAX + 8, 3 << 22])
def test_upload_is_an_upload_up_to_the_limit_and_a_wait_above(nbytes):
    t = torch.arange(nbytes // 8, dtype=torch.int64)
    out = timing.upload(t, torch.device("cpu"))
    assert torch.equal(out, t)
    small = nbytes <= timing.UPLOAD_MAX
    assert timing.COUNTERS["uploads"] == int(small)
    assert timing.COUNTERS["host_waits"] == int(not small)


class _RingEvent:
    """A stand-in CUDA event: passed unless the test holds it."""

    held: set = set()

    def __init__(self):
        self.stream = None
        self.waited = 0

    def record(self, stream):
        self.stream = stream

    def query(self):
        return self not in _RingEvent.held

    def synchronize(self):
        self.waited += 1
        _RingEvent.held.discard(self)


def test_staging_ring_reuses_a_slot_only_after_its_copies_ran(monkeypatch):
    """The ring's slots on a stand-in card: copies packed into a slot, the
    next slot taken when one does not fit or the stream changes, the
    slot's event recorded on its stream, a slot whose event has not passed
    waited for (one host wait, counted), and nothing allocated after the
    ring is made."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **kw:
                        empty(*a, **kw))       # no pinned memory here
    monkeypatch.setattr(torch.cuda, "Event", _RingEvent)
    monkeypatch.setattr(_RingEvent, "held", set())
    streams = {"now": "s0"}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: streams["now"])
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: streams["now"], raising=False)
    monkeypatch.setattr(timing, "UPLOAD_MAX", 1024)
    monkeypatch.setattr(timing, "STAGING_SLOTS", 3)
    cpu = torch.device("cpu")
    ring = timing._Staging()
    buf = ring.buf.data_ptr()
    assert ring.buf.numel() == 3 * 1024 and len(ring.events) == 3

    def put(n, fill):
        t = torch.full((n // 8,), fill, dtype=torch.int64)
        out = ring.put(t, cpu, 0)       # on the CPU: a view of the ring
        assert torch.equal(out, t)
        return out

    a = put(512, 1)
    b = put(8, 2)                       # packed after a, aligned
    assert (ring.slot, ring.used) == (0, 512 + 256)
    assert b.data_ptr() - a.data_ptr() == 512
    c = put(512, 3)                     # does not fit: slot 1
    assert ring.slot == 1 and ring.events[0].stream == "s0"
    assert c.data_ptr() == buf + 1024
    streams["now"] = "s1"
    put(8, 4)                           # another stream: slot 2
    assert ring.slot == 2 and ring.events[1].stream == "s0"
    _RingEvent.held.add(ring.events[0])  # slot 0's copies still queued
    put(1024, 5)                        # slot 2 is full: back to slot 0,
    assert ring.slot == 0               # after a wait for its event
    assert ring.events[0].waited == 1 and ring.events[2].stream == "s1"
    assert timing.COUNTERS["host_waits"] == 1
    assert torch.equal(a, torch.full((64,), 5, dtype=torch.int64))
    put(1024, 6)                        # slot 1 has passed: no wait
    assert ring.slot == 1 and timing.COUNTERS["host_waits"] == 1
    assert ring.buf.data_ptr() == buf and len(ring.events) == 3


# ---------------------------------------------------------------------------
# a toy prove on the CPU
# ---------------------------------------------------------------------------

def _toy(k: int = 5):
    """q·(a² − b) = 0, a ∈ {0..15}, b[2] copied from b[1] (the toy circuit
    of the JAX package's tests, built with the port's IR)."""
    n = 1 << k

    def u64col(vals):
        out = np.zeros((n, 2), np.uint32)
        out[: len(vals)] = u64.from_ints(list(vals))
        return out

    sel = np.zeros((n, 2), np.uint32)
    sel[:8, 0] = 1
    circ = CircuitDef(
        k=k, advice_names=["a", "b"], instance_names=[],
        fixed={"q": sel, "t": u64col(range(16))},
        gates=[Gate("square", V("q") * (V("a") * V("a") - V("b")))],
        lookups=[Lookup("a_range", ["a"], ["t"])],
        copies=[CopyGroup("b", np.array([1]), "b", np.array([2]))])
    circ.validate()
    a_vals = [(i * 7) % 16 for i in range(8)]
    a_vals[2] = a_vals[1]
    wit = {"a": u64col(a_vals), "b": u64col([v * v for v in a_vals])}
    return circ, {c: torch.from_numpy(v.astype(np.int64))
                  for c, v in wit.items()}


@pytest.fixture(scope="module")
def toy_proves():
    circ, wit = _toy(5)
    params = srs.load(os.path.join(CACHE, "srs_bn254_k5_s2.npz"),
                      device="cpu")
    pk = keygen.from_numpy(np.load(os.path.join(
        CACHE, f"pk_{keygen.circuit_fingerprint(circ)}.npz")), params, circ)
    m = Metrics(echo=False)
    waits, proofs = [], []
    for seed in (41, 42, 43):           # the first fills the key's caches
        kernels.reset_counts()
        with m.phase("prove"):
            proofs.append(prover.create_proof(params, pk, wit, {}, seed=seed,
                                              metrics=m))
        waits.append(dict(timing.COUNTERS))
    return m, waits, proofs


def test_toy_prove_counts_the_same_waits(toy_proves):
    _, waits, proofs = toy_proves
    assert [len(p) for p in proofs] == [928] * 3
    assert tuple(hashlib.sha256(p).hexdigest() for p in proofs) == TOY_PROOFS
    assert [w["proves"] for w in waits] == [1] * 3
    assert waits[1]["host_waits"] == waits[2]["host_waits"] == TOY_WAITS
    assert waits[1]["uploads"] == waits[2]["uploads"] == TOY_UPLOADS
    # the first fills the key's caches: more uploads, no more waits
    assert waits[0]["host_waits"] == TOY_WAITS
    assert waits[0]["uploads"] > TOY_UPLOADS


def test_toy_prove_spans(toy_proves):
    m, _, _ = toy_proves
    ids = sorted({p.prove for p in m.phases})
    assert len(ids) == 3
    one = [p for p in m.phases if p.prove == ids[1]]
    labels = [p.label for p in one]
    assert labels[-1] == "prove"
    for want in ("prove.init", "prove.lookup_sort", "prove.intt",
                 "prove.claims", "prove.advice_commit.prep",
                 "prove.lookup_permute.columns", "prove.lookup_permute.intt",
                 "prove.grand_products_commit.perm_z",
                 "prove.grand_products_commit.lookup_z",
                 "prove.grand_products_commit.intt",
                 "prove.quotient.extend", "prove.quotient.constraints",
                 "prove.quotient.h", "prove.evaluations.grid",
                 "prove.evaluations.read", "prove.multiopen.h_pass",
                 "prove.multiopen.l_pass", "prove.advice_commit.msm",
                 "prove.quotient.msm", "prove.multiopen.msm"):
        assert want in labels, want
    by = {p.label: p for p in one}
    assert all(p.parent in by for p in one if p.parent)
    # each span's waits lie within its parent's
    for p in one:
        if p.parent:
            assert p.waits <= by[p.parent].waits
    assert by["prove"].waits == toy_proves[1][1]["host_waits"]
    assert by["prove.quotient.msm"].counts["points"] > 0


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _reader(name):
    path = os.path.join(REPO, "zkbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


WINDOW = [{"prove": 0.2, "prove.quotient.constraints": 0.010,
           "prove.quotient.msm": 0.004, "prove.multiopen.msm": 0.002},
          {"prove": 0.2, "prove.quotient.constraints": 0.012,
           "prove.quotient.msm": 0.006, "prove.multiopen.msm": 0.002}]


@pytest.mark.parametrize("name,want", [
    ("host_waits_per_prove", 150.0), ("host_wait_ms", 25.0),
    ("constraints_ms", 11.0), ("msm_ms", 7.0), ("params_s", 1.5),
    ("uploads_per_prove", 240.0)])
def test_readers(name, want):
    timing.COUNTERS.update(host_waits=300, host_wait_s=0.05, uploads=480,
                           proves=2)
    ctx = {"run": Run(window_phases=WINDOW,
                      setup_phases={"setup": 3.0, "setup.params": 1.5})}
    assert _reader(name)(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", ["host_waits_per_prove", "host_wait_ms",
                                  "constraints_ms", "msm_ms", "params_s",
                                  "uploads_per_prove"])
def test_readers_give_none_without_spans_or_proves(name):
    timing.COUNTERS.update(host_waits=7, host_wait_s=0.01, uploads=9,
                           proves=0)
    ctx = {"run": Run(window_phases=[{"prove": 0.2, "prove.quotient": 0.05}],
                      setup_phases={"setup": 3.0})}
    assert _reader(name)(ctx) is None


def test_uploads_reader_gives_none_where_the_program_counts_no_uploads(
        monkeypatch):
    """A program whose counters lack ``uploads`` (one older than the
    staged copies) reads None, whatever it proved."""
    monkeypatch.setattr(timing, "COUNTERS",
                        {"host_waits": 684, "host_wait_s": 0.16, "proves": 2})
    assert _reader("uploads_per_prove")({"run": Run()}) is None
    assert _reader("host_waits_per_prove")({"run": Run()}) == 342.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    """scheme -> (pipeline, prove(seed)) at k = 17, 37 random compressions
    a prove, made at first use and warmed by two proves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    made = {}

    def get(scheme):
        if scheme not in made:
            made[scheme] = _pipeline(scheme)
        return made[scheme]

    yield get
    made.clear()


def _pipeline(scheme):
    from zkodst_tpu_torch import api

    pipe = api.setup_blake2f(k=17, n_inst=37, echo=False, scheme=scheme,
                             device="cuda")
    rng = np.random.default_rng(19)

    def prove(seed):
        h = rng.integers(0, 1 << 32, (37, 8, 2))
        m = rng.integers(0, 1 << 32, (37, 16, 2))
        t = np.zeros((37, 2, 2), np.int64)
        t[:, 0] = rng.integers(0, 1 << 32, (37, 2))
        f = rng.integers(0, 2, 37).astype(bool)
        return pipe.prove(h, m, t, f, seed=seed)

    for seed in (1, 2):
        prove(seed)
    torch.cuda.synchronize()
    return pipe, prove


def _events() -> int:
    """CUDA events alive (no weak reference: the card's torch crashes at
    exit on one to an event)."""
    return sum(isinstance(o, torch.cuda.Event) for o in gc.get_objects())


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["kzg", "ipa"])
def test_waits_equal_the_sync_debug_count_on_the_card(pipelines, scheme,
                                                      monkeypatch):
    pipe, prove = pipelines(scheme)
    made = []
    event = timing._event

    def counted(stream):
        made.append(1)
        return event(stream)

    monkeypatch.setattr(timing, "_event", counted)
    gc.collect()
    held = _events()
    n0 = len(pipe.metrics.phases)
    kernels.reset_counts()
    seen = []

    def show(message, *args, **kw):
        # (a sync reported, raised under the outermost span's close); the
        # mode's own notice that it is a prototype is no sync
        seen.append(("called a synchronizing CUDA operation" in str(message),
                     any(f.name == "_resolve" for f in
                         traceback.extract_stack())))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            prove(3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the outermost span's explicit synchronize is counted apart, whether
    # the debug mode reports it or not
    syncs = sum(sync and not anchor for sync, anchor in seen)
    assert timing.COUNTERS["proves"] == 1
    assert timing.COUNTERS["host_waits"] == syncs + 1
    gc.collect()
    assert len(made) == 2 * (len(pipe.metrics.phases) - n0)   # a pair each
    gc.collect()
    assert _events() == held
    assert not [sp for sp in gc.get_objects() if isinstance(sp, timing._Span)
                and (sp.ev0 is not None or sp.ev1 is not None)]


@contextlib.contextmanager
def _synced_phases(metrics):
    """Every phase of `metrics` synchronizes at its end (the old timing)."""
    orig = metrics.phase

    @contextlib.contextmanager
    def phase(label):
        with orig(label):
            yield
            torch.cuda.synchronize()

    metrics.phase = phase
    try:
        yield
    finally:
        del metrics.phase


PHASES = ("prove", "prove.witness", "prove.advice_commit",
          "prove.lookup_permute", "prove.grand_products_commit",
          "prove.quotient", "prove.evaluations", "prove.multiopen")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["kzg", "ipa"])
def test_phase_times_match_synchronized_phases_on_the_card(pipelines,
                                                           scheme):
    pipe, prove = pipelines(scheme)
    free, synced = {}, {}
    for i in range(60):                 # in turns, against the host's drift
        into = synced if i % 2 else free
        n0 = len(pipe.metrics.phases)
        with (_synced_phases(pipe.metrics) if i % 2
              else contextlib.nullcontext()):
            prove(10 + i)
        for p in pipe.metrics.phases[n0:]:
            if p.label in PHASES:
                into.setdefault(p.label, []).append(p.seconds)
    free = {k: statistics.median(v) for k, v in free.items()}
    synced = {k: statistics.median(v) for k, v in synced.items()}
    assert free.keys() == synced.keys() == set(PHASES)
    off = {label: (free[label], s) for label, s in synced.items()
           if abs(free[label] - s) > max(0.1 * s, 1e-4)}
    assert not off, off


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,most", [("kzg", 45), ("ipa", 120)])
def test_a_steady_prove_waits_only_where_the_data_needs_it_on_the_card(
        pipelines, scheme, most):
    """Reads, boolean masks and the anchor wait; every copy of a steady
    prove is an upload, as many in each prove."""
    _, prove = pipelines(scheme)
    got = []
    for seed in (4, 5):
        kernels.reset_counts()
        prove(seed)
        got.append(dict(timing.COUNTERS))
    print(scheme, got)
    assert [c["proves"] for c in got] == [1, 1]
    assert all(c["host_waits"] <= most for c in got), got
    assert got[0]["uploads"] == got[1]["uploads"] > 0, got


def _pinned():
    """torch's pinned allocations so far (where this torch counts them),
    and each staging ring's buffer."""
    stats = (torch.cuda.host_memory_stats()
             if hasattr(torch.cuda, "host_memory_stats") else {})
    return (stats.get("num_host_alloc", stats.get("allocations.allocated")),
            {i: (r.buf.data_ptr(), r.buf.numel())
             for i, r in timing._STAGING.items()})


@pytest.mark.cuda
def test_ten_steady_proves_allocate_no_pinned_memory(pipelines):
    _, prove = pipelines("kzg")
    before = _pinned()
    assert before[1], "the warm-up proves made no staging ring"
    for seed in range(20, 30):
        prove(seed)
    assert _pinned() == before


@pytest.mark.cuda
def test_uploads_read_at_once_behind_a_busy_stream_on_the_card():
    """A spin kernel holds the stream while 3 rings' worth of 2 MiB
    uploads are made, each read at once by kernel 2 (x + 0) and its host
    source overwritten: every sum equals the values uploaded, and the ring
    waited before it wrote a slot whose copies had not run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zkodst_tpu_torch.ops.field import FR

    dev = torch.device("cuda")
    n = (1 << 21) // 32                        # 2 MiB of elements
    count = 3 * timing.STAGING_SLOTS * (timing.UPLOAD_MAX >> 21) // 2
    rng = np.random.default_rng(20)
    want = [rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
            .astype(np.uint32) for _ in range(count)]
    for a in want:
        a[:, 7] &= 0x0FFFFFFF                  # below p: a + 0 = a
    zero = torch.zeros(8, dtype=torch.int32, device=dev)
    FR.add(zero[None], zero)                   # built and loaded
    torch.cuda.synchronize()
    kernels.reset_counts()
    torch.cuda._sleep(400_000_000)             # ~0.2 s of spin
    sums = []
    for a in want:
        src = torch.from_numpy(a.view(np.int32).copy())
        sums.append(FR.add(timing.upload(src, dev), zero))
        src.fill_(-1)
    torch.cuda.synchronize()
    for a, s in zip(want, sums):
        assert np.array_equal(s.cpu().numpy().view(np.uint32), a)
    assert timing.COUNTERS["uploads"] == count
    assert timing.COUNTERS["host_waits"] >= 1

