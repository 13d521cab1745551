"""The port's SRS and proving-key caches at k = 5 against the JAX
package's: an SRS saved by either package loads in the other with equal
points; a key cached by the port loads in the JAX keygen with the golden
vk digest, and a key cached by the JAX package (the committed
``tests/golden/dryrun_cache``) loads in the port's keygen with it; a
second setup from a cache writes no file; a stale file is made again."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import test_circuit_ir as jtoy
from test_torch_keygen import CACHE, GOLDEN, params_for, toy, vk_digest
from zkodst_tpu.ops import curve as jcurve
from zkodst_tpu.proof import keygen as jkeygen
from zkodst_tpu.proof import srs as jsrs
from zkodst_tpu.proof import transcript as jtranscript
from zkodst_tpu_torch.ops import curve
from zkodst_tpu_torch.ops.field import to_limbs16
from zkodst_tpu_torch.proof import keygen, srs

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def _golden_digest():
    with open(os.path.join(GOLDEN, "toy_proof_v1.json")) as fh:
        return json.load(fh)["vk_transcript_digest"]


def _listing(path):
    return sorted((f, os.stat(os.path.join(path, f)).st_mtime_ns)
                  for f in os.listdir(path))


def test_srs_saved_by_port_loads_in_jax(tmp_path):
    params = params_for(5)
    path = str(tmp_path / "srs.npz")
    srs.save(params, path)
    jp = jsrs.load(path)
    assert jp.k == 5 and jp.g2 == params.g2 and jp.s_g2 == params.s_g2
    for got, mine in ((jp.g1, params.g1), (jp.g1_lagrange,
                                            params.g1_lagrange)):
        np.testing.assert_array_equal(got, to_limbs16(mine))
        assert jcurve.to_affine_ints(got) == curve.to_affine_ints(mine)


def test_srs_saved_by_jax_loads_in_port(tmp_path):
    jp = jsrs.load(os.path.join(CACHE, "srs_bn254_k5_s2.npz"))
    path = str(tmp_path / "srs.npz")
    jsrs.save(jp, path)
    tp = srs.load(path, device="cpu")
    assert tp.k == 5 and tp.g2 == jp.g2 and tp.s_g2 == jp.s_g2
    assert curve.to_affine_ints(tp.g1) == jcurve.to_affine_ints(jp.g1)
    assert curve.to_affine_ints(tp.g1_lagrange) == \
        jcurve.to_affine_ints(jp.g1_lagrange)


def test_get_or_create_writes_once_and_remakes_a_stale_file(tmp_path,
                                                            capsys):
    d = str(tmp_path)
    made = srs.get_or_create(5, d, seed=2, device="cpu")
    assert _listing(d)[0][0] == "srs_bn254_k5_s2.npz"
    before = _listing(d)
    again = srs.get_or_create(5, d, seed=2, device="cpu")
    assert _listing(d) == before
    want = params_for(5)
    for p in (made, again):
        assert torch.equal(p.g1, want.g1)
        assert torch.equal(p.g1_lagrange, want.g1_lagrange)
        assert p.s_g2 == want.s_g2
    with open(os.path.join(d, "srs_bn254_k5_s2.npz"), "wb") as fh:
        fh.write(b"not an npz")
    remade = srs.get_or_create(5, d, seed=2, device="cpu")
    assert "stale SRS cache" in capsys.readouterr().out
    assert torch.equal(remade.g1_lagrange, want.g1_lagrange)
    assert torch.equal(srs.load(os.path.join(d, "srs_bn254_k5_s2.npz"),
                                device="cpu").g1, want.g1)


def test_key_cached_by_port_loads_in_jax(tmp_path):
    d = str(tmp_path)
    circ, _ = toy(5)
    pk = keygen.keygen(params_for(5), circ, cache_dir=d)
    name = f"pk_{keygen.circuit_fingerprint(circ)}.npz"
    assert [f for f, _ in _listing(d)] == [name]
    before = _listing(d)
    again = keygen.keygen(params_for(5), circ, cache_dir=d)
    assert _listing(d) == before                  # read, not written
    assert vk_digest(again.vk) == vk_digest(pk.vk) == _golden_digest()
    for k in pk.ext_selectors:
        assert torch.equal(again.ext_selectors[k], pk.ext_selectors[k])
    jpk = jkeygen.keygen(jsrs.load(os.path.join(CACHE, "srs_bn254_k5_s2.npz")),
                         jtoy.toy_circuit(), cache_dir=d)
    assert _listing(d) == before
    tw = jtranscript.Blake2bWrite()
    jpk.vk.hash_into(tw)
    assert hex(tw.squeeze_challenge()) == _golden_digest()
    for k, v in jpk.ext_selectors.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      to_limbs16(pk.ext_selectors[k]))


def test_key_cached_by_jax_loads_in_port(tmp_path):
    d = str(tmp_path / "cache")
    shutil.copytree(CACHE, d)
    before = _listing(d)
    circ, _ = toy(5)
    pk = keygen.keygen(params_for(5), circ, cache_dir=d)
    assert _listing(d) == before
    assert vk_digest(pk.vk) == _golden_digest()


def test_stale_key_cache_is_made_again(tmp_path, capsys):
    d = str(tmp_path)
    circ, _ = toy(5)
    path = os.path.join(d, f"pk_{keygen.circuit_fingerprint(circ)}.npz")
    np.savez_compressed(path, sig_col=np.zeros(3))   # an older format
    pk = keygen.keygen(params_for(5), circ, cache_dir=d)
    assert "stale pk cache" in capsys.readouterr().out
    assert vk_digest(pk.vk) == _golden_digest()
    with np.load(path) as npz:
        assert "sel_zh_inv" in npz and npz["sig_col"].shape == (2, 32)


def test_setup_blake2f_takes_no_ipa(monkeypatch):
    """setup_blake2f(scheme="ipa") makes the IPA generators (from the
    cache directory) and the key on them, not an SRS (the circuit, the
    generators and the keygen stubbed: the real ones are the flagship's);
    an unknown scheme raises."""
    from zkodst_tpu_torch import api
    from zkodst_tpu_torch.proof import ipa

    calls = []
    monkeypatch.setattr(api.blake2f_circuit, "Blake2fCircuit",
                        lambda **kw: type("B", (), {"circ": "circ"})())
    monkeypatch.setattr(ipa, "setup", lambda k, cache_dir=None, device=None:
                        calls.append(("ipa", k, cache_dir)) or "gens")
    monkeypatch.setattr(srs, "setup", lambda *a, **kw: calls.append("srs"))
    monkeypatch.setattr(keygen, "keygen", lambda params, circ, cache_dir:
                        calls.append(("keygen", params, cache_dir)) or "pk")
    pr = api.setup_blake2f(k=17, n_inst=1, scheme="ipa", cache_dir="d",
                           echo=False, device="cpu")
    assert calls == [("ipa", 17, "d"), ("keygen", "gens", "d")]
    assert (pr.params, pr.pk) == ("gens", "pk")
    with pytest.raises(ValueError, match="scheme"):
        api.setup_blake2f(k=17, n_inst=1, scheme="fri", device="cpu")
