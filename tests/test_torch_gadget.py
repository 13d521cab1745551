"""The port's BLAKE2b gadget, its batched ``blake2f`` and the EIP-152
codec, against ``hashlib`` and the JAX package's on the same inputs
(following ``tests/test_gadget.py``): digests of every size, chunked
updates, the chain rules and their tampering cases, ``calls_to_arrays``
padding, ``blake2f`` on random batches, every appendix vector decoded or
rejected as the reference does, and the chain read back from the port's
witness of a 3-block message."""

import hashlib

import numpy as np
import pytest
import torch

from zkodst_tpu import gadget as jgadget
from zkodst_tpu.ops import blake2 as jblake2
from zkodst_tpu_torch import gadget
from zkodst_tpu_torch.ops import blake2, u64

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

MSG = b"x" * 300          # 3 blocks (128 + 128 + 44 bytes)


@pytest.mark.parametrize("size", [0, 1, 3, 64, 127, 128, 129, 256, 300,
                                  1000])
def test_digest_matches_hashlib_and_jax(size):
    data = bytes((i * 7 + 3) % 256 for i in range(size))
    digest, calls = gadget.Blake2b.digest(data)
    assert digest == hashlib.blake2b(data).digest()
    assert blake2.blake2b_py(data) == digest
    _, jcalls = jgadget.Blake2b.digest(data)
    assert [vars(c) for c in calls] == [vars(c) for c in jcalls]
    assert gadget.check_chain(calls, len(data))
    assert gadget.chain_digest(calls) == digest


def test_digest_sizes():
    for ds in (1, 20, 32, 48, 64):
        digest, calls = gadget.Blake2b.digest(b"abc", ds)
        assert digest == hashlib.blake2b(b"abc", digest_size=ds).digest()
        assert blake2.blake2b_py(b"abc", ds) == digest
        assert gadget.check_chain(calls, 3, ds)
    with pytest.raises(ValueError):
        gadget.Blake2b(65)


def test_streaming_chunked_update_equivalence():
    data = bytes(range(256)) * 3
    h = gadget.Blake2b()
    for i in range(0, len(data), 37):
        h.update(data[i:i + 37])
    d1, calls1 = h.finalize()
    d2, calls2 = gadget.Blake2b.digest(data)
    assert d1 == d2 == hashlib.blake2b(data).digest()
    assert calls1 == calls2
    with pytest.raises(RuntimeError):
        h.update(b"more")


def _forged_middle(calls):
    c1 = calls[1]
    bad_h = tuple(x ^ 1 for x in c1.h)
    return gadget.BlockCall(
        h=bad_h, m=c1.m, t=c1.t, f=c1.f,
        h_out=tuple(blake2.blake2f_py(list(bad_h), list(c1.m), c1.t, c1.f)))


def test_chain_check_rejects_tampering():
    _, calls = gadget.Blake2b.digest(MSG)
    assert gadget.check_chain(calls, 300)
    cases = {
        "broken h chain": [calls[0], gadget.BlockCall(
            calls[0].h, calls[1].m, calls[1].t, calls[1].f,
            calls[1].h_out), calls[2]],
        "early final flag": [gadget.BlockCall(
            calls[0].h, calls[0].m, calls[0].t, True, calls[0].h_out),
            *calls[1:]],
        "missing block": calls[:-1],
        "forged middle block": [calls[0], _forged_middle(calls), calls[2]],
        "wrong length": calls,
    }
    for what, bad in cases.items():
        n = 299 if what == "wrong length" else 300
        assert not gadget.check_chain(bad, n), what
        jbad = [jgadget.BlockCall(**vars(c)) for c in bad]
        assert not jgadget.check_chain(jbad, n), what
    assert not gadget.check_chain([], 0)


def test_calls_to_arrays_padding_equals_jax():
    _, calls = gadget.Blake2b.digest(b"y" * 200)
    got = gadget.calls_to_arrays(calls, pad_to=5)
    want = jgadget.calls_to_arrays(
        [jgadget.BlockCall(**vars(c)) for c in calls], pad_to=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    h, m, t, f = got
    assert h.shape == (5, 8, 2) and m.shape == (5, 16, 2)
    assert t.shape == (5, 2, 2) and f.shape == (5,)
    assert np.array_equal(h[2], h[4])
    with pytest.raises(ValueError):
        gadget.calls_to_arrays(calls, pad_to=1)


@pytest.mark.parametrize("rounds", [0, 1, 12])
def test_blake2f_equals_jax(rounds):
    rng = np.random.default_rng(40 + rounds)
    shape = (3, 2)
    h = rng.integers(0, 1 << 32, shape + (8, 2), dtype=np.uint64)
    m = rng.integers(0, 1 << 32, shape + (16, 2), dtype=np.uint64)
    t = rng.integers(0, 1 << 32, shape + (2, 2), dtype=np.uint64)
    f = rng.integers(0, 2, shape).astype(bool)
    h, m, t = (x.astype(np.uint32) for x in (h, m, t))
    got = blake2.blake2f(*(torch.from_numpy(x.astype(np.int64))
                           for x in (h, m, t)), torch.from_numpy(f), rounds)
    want = np.asarray(jblake2.blake2f(h, m, t, f, rounds))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    ints = u64.to_ints(got)
    for i in np.ndindex(shape):
        assert list(ints[i]) == blake2.blake2f_py(
            list(u64.to_ints(h[i])), list(u64.to_ints(m[i])),
            tuple(u64.to_ints(t[i])), bool(f[i]), rounds)


def test_eip152_vectors_as_jax():
    assert blake2.EIP152_INPUT_LEN == jblake2.EIP152_INPUT_LEN
    assert len(blake2.EIP152_VECTORS) == len(jblake2.EIP152_VECTORS) == 8
    for v, jv in zip(blake2.EIP152_VECTORS, jblake2.EIP152_VECTORS):
        assert v == jv
        if "error" in v:
            with pytest.raises(ValueError, match=v["error"]):
                blake2.eip152_decode(v["input"])
            continue
        got = blake2.eip152_decode(v["input"])
        assert got == jblake2.eip152_decode(jv["input"])
        assert blake2.eip152_encode(*got) == v["input"]
        if v["expected"] is not None:
            rounds, h, m, t, f = got
            out = blake2.blake2f_py(h, m, t, f, rounds)
            assert b"".join(x.to_bytes(8, "little")
                            for x in out).hex() == v["expected"]


def test_chain_read_back_from_the_witness():
    """The 3-block chain through the port's witness at k = 17 (the proof
    itself is made on the card by chip_smoke.py): the public column holds
    each call, the chain rules pass on it, and a forged middle block
    fails them."""
    from zkodst_tpu_torch.circuit import blake2f as bc

    digest, calls = gadget.Blake2b.digest(MSG)
    built = bc.Blake2fCircuit(k=17, n_inst=4, rounds=12, device="cpu")
    _, inst = built.witness(*gadget.calls_to_arrays(calls, pad_to=4))
    proved = gadget.instance_column_calls(built, inst["pub"], 3)
    assert proved == calls
    assert gadget.check_chain(proved, len(MSG))
    assert gadget.chain_digest(proved) == digest == hashlib.blake2b(
        MSG).digest()
    forged = [proved[0], _forged_middle(proved), proved[2]]
    assert not gadget.check_chain(forged, len(MSG))
