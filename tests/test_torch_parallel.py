"""The port's sharded operations (``zkodst_tpu_torch/parallel/``) in gloo
ranks on the CPU, each held bit for bit to the JAX package's single-device
function on the same inputs, as ``tests/test_parallel.py`` holds the JAX
sharded ops: the 4-step NTT and its inverse (C layout and natural order,
batched), the MSM and the Python-int sum, the prefix product with its
total, at world sizes 2 and 4, and a 2 × 2 ("host", "chip") mesh with a
tuple axis. Exact equality: the outputs are canonical field values and
affine points.

Ranks are spawned processes (one intra-op thread each) that meet through
a ``file://`` store under the test's temporary directory; the parent joins
them with a deadline and kills them on expiry, so a collective that hangs
fails its test instead of the run. :func:`ranks` and :class:`Ranks` are
shared with ``test_torch_parallel_proof.py``. JAX is imported by the
tests alone, not by the ranks."""

import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from zkodst_tpu_torch.ops import curve
from zkodst_tpu_torch.ops import pycurve as tpycurve
from zkodst_tpu_torch.ops.field import FR, ints_to_limbs, to_limbs16
from zkodst_tpu_torch.ops.pyfield import FR as PFR
from zkodst_tpu_torch.parallel import bootstrap, msm_sharded, ntt_sharded, \
    scan_sharded

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

K = 6
N = 1 << K
# a collective that waits longer than this raises in its rank
COLLECTIVE_S = 120


def _rank_main(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), world_size=world, rank=rank,
        timeout=timedelta(seconds=COLLECTIVE_S))
    try:
        out = fn(world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


class Ranks:
    """`world` spawned gloo ranks, each running fn(world, *args) and
    saving what it returns."""

    def __init__(self, fn, world: int, tmp, *args):
        self.tmp, self.world = str(tmp), world
        os.makedirs(self.tmp, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, self.tmp, args),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float) -> list:
        """Every rank's result, in rank order; fails the test if a rank
        exits non-zero or is still running after `timeout` seconds."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for r in hung:
            self.procs[r].kill()
        for p in self.procs:
            p.join(10)
        if hung:
            pytest.fail(f"ranks {hung} of {self.world} still running after "
                        f"{timeout} s: killed")
        bad = {r: p.exitcode for r, p in enumerate(self.procs) if p.exitcode}
        if bad:
            pytest.fail(f"ranks exited with {bad} (their tracebacks are on "
                        "stderr)")
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def ranks(fn, world, tmp, *args, timeout=300):
    """Run fn in `world` gloo ranks and return their results."""
    return Ranks(fn, world, tmp, *args).results(timeout)


# -- inputs, made from a seed with numpy ----------------------------------------

RNG = np.random.default_rng(5)
COL = [int(x) for x in RNG.integers(0, 1 << 62, N)]
BATCH = [[int(x) for x in row] for row in RNG.integers(0, 1 << 62, (3, N))]
SCAN = [int(x) for x in RNG.integers(1, 1 << 62, N)]
MSM_N = 16
SCALARS = [int(x) for x in RNG.integers(1, 1 << 62, MSM_N)]


def _ops(world):
    """Every sharded op on this rank's mesh: limbs16 arrays and points."""
    mesh = bootstrap.make_mesh((world,), ("x",))
    w = PFR.root_of_unity(K)
    out = {"index": mesh.index("x")}
    a = FR.from_ints(COL)
    c = ntt_sharded.ntt_sharded(FR, a, w, mesh, "x")
    out["ntt"] = to_limbs16(ntt_sharded.to_natural(c, 8))
    out["ntt_back"] = to_limbs16(ntt_sharded.intt_sharded(FR, c, w, mesh))
    b = FR.from_ints(BATCH)
    nat = ntt_sharded.ntt_sharded_nat(FR, b, w, mesh, "x")
    out["ntt_nat"] = to_limbs16(nat)
    out["ntt_nat_back"] = to_limbs16(
        ntt_sharded.intt_sharded_nat(FR, nat, w, mesh, "x"))
    pts = curve.from_affine_ints([tpycurve.G1.mul(tpycurve.G1_GEN, i + 1)
                                  for i in range(MSM_N)])
    normal = FR.const(ints_to_limbs(SCALARS))
    out["msm"] = curve.to_affine_ints(
        msm_sharded.msm_sharded(pts, normal, mesh, "x", c=8)[None])
    mont = torch.stack([FR.from_ints(SCALARS), FR.from_ints(SCALARS[::-1])])
    out["msm_mont"] = curve.to_affine_ints(
        msm_sharded.msm_many_sharded_mont(pts, mont, mesh, "x", c=8))
    incl, total = scan_sharded.cumprod_incl_sharded(FR, FR.from_ints(SCAN),
                                                    mesh, "x")
    out["scan"], out["scan_total"] = to_limbs16(incl), to_limbs16(total)
    try:
        bootstrap.make_mesh((world + 1,), ("x",))
    except ValueError as ex:
        out["wrong_shape"] = str(ex)
    if world == 4:
        mesh2 = bootstrap.make_mesh((2, 2), ("host", "chip"))
        ax = ("host", "chip")
        out["size_2d"] = (bootstrap.axis_size(mesh2, ax),
                          mesh2.size("chip"), mesh2.index(ax))
        out["ntt_2d"] = to_limbs16(
            ntt_sharded.ntt_sharded_nat(FR, b, w, mesh2, ax))
        # one axis of the 2-D mesh: two groups of two ranks each
        out["scan_chip"] = to_limbs16(scan_sharded.cumprod_incl_sharded(
            FR, FR.from_ints(SCAN), mesh2, "chip")[0])
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's single-device results on the same inputs."""
    import jax.numpy as jnp

    from zkodst_tpu.ops import curve as jcurve
    from zkodst_tpu.ops import msm as jmsm
    from zkodst_tpu.ops import ntt as jntt
    from zkodst_tpu.ops import pycurve as jpycurve
    from zkodst_tpu.ops.field import FR as JF
    from zkodst_tpu.proof.prover import _cumprod_incl

    w = PFR.root_of_unity(K)
    pts_aff = [jpycurve.G1.mul(jpycurve.G1_GEN, i + 1) for i in range(MSM_N)]
    limbs = np.zeros((MSM_N, 16), np.uint32)
    for i, s in enumerate(SCALARS):
        for j in range(4):
            limbs[i, j] = (s >> (16 * j)) & 0xFFFF
    total = None
    for s, p in zip(SCALARS, pts_aff):
        total = jpycurve.G1.add(total, jpycurve.G1.mul(p, s))
    scan = np.asarray(_cumprod_incl(jnp.asarray(JF.from_ints(SCAN))))
    return {
        "col": np.asarray(JF.from_ints(COL)),
        "batch": np.asarray(JF.from_ints(BATCH)),
        "ntt": np.asarray(jntt.ntt(JF, jnp.asarray(JF.from_ints(COL)), w)),
        "ntt_nat": np.asarray(jntt.ntt(JF, jnp.asarray(JF.from_ints(BATCH)),
                                       w)),
        "msm": jcurve.to_affine_ints(np.asarray(jmsm.msm(
            jcurve.from_affine_ints(pts_aff), limbs, 8))[None]),
        "msm_sum": [total],
        "scan": scan, "scan_total": scan[-1]}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The ranks at world sizes 2 and 4, started side by side."""
    return {w: Ranks(_ops, w, tmp_path_factory.mktemp(f"ops{w}"))
            for w in (2, 4)}


@pytest.fixture(scope="module")
def sharded(jobs, jax_refs):
    """The ranks' results (the JAX references run while they work)."""
    return {w: job.results(300) for w, job in jobs.items()}


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_ntt_sharded_matches_jax(sharded, jax_refs, world):
    for r, out in enumerate(sharded[world]):
        assert out["index"] == r
        np.testing.assert_array_equal(out["ntt"], jax_refs["ntt"])
        np.testing.assert_array_equal(out["ntt_back"], jax_refs["col"])


@pytest.mark.parametrize("world", WORLDS)
def test_ntt_sharded_nat_matches_jax(sharded, jax_refs, world):
    for out in sharded[world]:
        np.testing.assert_array_equal(out["ntt_nat"], jax_refs["ntt_nat"])
        np.testing.assert_array_equal(out["ntt_nat_back"], jax_refs["batch"])


@pytest.mark.parametrize("world", WORLDS)
def test_msm_sharded_matches_jax_and_the_int_sum(sharded, jax_refs, world):
    assert jax_refs["msm"] == jax_refs["msm_sum"]
    for out in sharded[world]:
        assert out["msm"] == jax_refs["msm"]
        assert out["msm_mont"][0] == jax_refs["msm"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_msm_many_sharded_mont_batches(sharded, world):
    """The second row (scalars reversed) against the single-device MSM."""
    from zkodst_tpu_torch.ops import msm

    pts = curve.from_affine_ints([tpycurve.G1.mul(tpycurve.G1_GEN, i + 1)
                                  for i in range(MSM_N)])
    want = curve.to_affine_ints(msm.msm_many_mont(
        pts, FR.from_ints(SCALARS[::-1])[None], c=8))
    for out in sharded[world]:
        assert out["msm_mont"][1:] == want


@pytest.mark.parametrize("world", WORLDS)
def test_cumprod_sharded_matches_jax(sharded, jax_refs, world):
    for out in sharded[world]:
        np.testing.assert_array_equal(out["scan"], jax_refs["scan"])
        np.testing.assert_array_equal(out["scan_total"],
                                      jax_refs["scan_total"])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shape_must_hold_the_world(sharded, world):
    for out in sharded[world]:
        assert f"holds {world + 1} ranks, the job has {world}" \
            in out["wrong_shape"]


def test_2d_mesh_tuple_axis(sharded, jax_refs):
    """A 2 × 2 ("host", "chip") mesh: the flattened tuple axis and one
    axis of it (two groups of two) give the single-device results."""
    for r, out in enumerate(sharded[4]):
        assert out["size_2d"] == (4, 2, r)
        np.testing.assert_array_equal(out["ntt_2d"], jax_refs["ntt_nat"])
        np.testing.assert_array_equal(out["scan_chip"], jax_refs["scan"])


# -- without a process group -----------------------------------------------------

def test_init_distributed_is_a_noop_outside_a_job(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert bootstrap.init_distributed() is None
    assert not dist.is_initialized()


def test_init_distributed_defaults_to_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bootstrap.init_distributed()
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        bootstrap.make_mesh((2,), ("x",))


@pytest.mark.parametrize("n, ndev, want", [
    (1 << 6, 2, (8, 8)), (1 << 6, 4, (8, 8)), (1 << 17, 2, (256, 512)),
    (1 << 19, 4, (512, 1024)), (1 << 5, 4, (4, 8)), (1 << 6, 1, (8, 8))])
def test_factor_splits_for_the_shards(n, ndev, want):
    assert ntt_sharded._factor(n, ndev) == want


@pytest.mark.parametrize("n, ndev", [(1 << 6, 3), (1 << 6, 16), (16, 8)])
def test_factor_refuses_shards_that_do_not_divide(n, ndev):
    with pytest.raises(ValueError, match="no 4-step split"):
        ntt_sharded._factor(n, ndev)
