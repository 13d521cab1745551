"""Command line: ``python -m zkodst_tpu_torch <command>``, as
``python -m zkodst_tpu``, on the card unless ``--device cpu`` is given.

  prove    setup → prove → verify of the EIP-152 vector at the configured
           degree and instance count; prints the metrics JSON, the
           prove's spans, ``{"prove_spans": [...]}`` (each span's label,
           parent, times on the host and the device, launches, host waits
           and an MSM's sizes), then ``{"proof_bytes": ..., "verified":
           ...}`` last. With ``--mesh N`` (or
           ``HxC``) the proof is sharded over N ranks, one process each:
           ``python -m torch.distributed.run --nproc-per-node N -m
           zkodst_tpu_torch prove --mesh N``; rank 0 alone prints.
  mock     the witness and the constraint check without cryptography
  vectors  the EIP-152 appendix vectors through the batched compression
           (kernel 14 on the card)
  bench    staged JSON lines (:mod:`.bench`): witness throughput, then the
           flagship's prove throughput at k = 17 from ``--cache-dir`` with
           its checks; it takes ``--device`` and ``--cache-dir`` only
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--k", type=int, default=None, help="circuit degree "
                   "(2^k rows; default DEGREE env or 17)")
    p.add_argument("--instances", type=int, default=None,
                   help="BLAKE2f instances per proof")
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--cache-dir", default=".zkodst_cache")
    p.add_argument("--seed", type=int, default=None,
                   help="deterministic blinding seed (default: OS entropy)")
    p.add_argument("--mesh", default=None,
                   help="mesh shape, e.g. '8' or '2x4' (multi-GPU prover, "
                        "under torch.distributed.run)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend of a mesh (default: nccl on "
                        "CUDA, gloo on the CPU; gloo for ranks that share "
                        "one card)")
    p.add_argument("--commitment", default="kzg", choices=("kzg", "ipa"),
                   help="polynomial commitment scheme: kzg (BN254 + "
                        "SHPLONK) or ipa (transparent, BN254)")
    p.add_argument("--transcript-mode", default="v1",
                   choices=("v1", "halo2ce"),
                   help="transcript flavor: v1 (pinned native format) or "
                        "halo2ce (per-value instance absorption)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    p.add_argument("--quiet", action="store_true")


def _config(args):
    from .config import RunConfig

    kw = {}
    if args.k is not None:
        kw["k"] = args.k
    if args.instances is not None:
        kw["n_inst"] = args.instances
    if args.mesh:
        kw["mesh_shape"] = tuple(int(x) for x in args.mesh.split("x"))
        kw["mesh_axes"] = ("host", "chip")[-len(kw["mesh_shape"]):]
    return RunConfig(rounds=args.rounds, cache_dir=args.cache_dir,
                     seed=args.seed, echo=not args.quiet,
                     commitment=args.commitment, device=args.device, **kw)


def _join(cfg, args):
    """This rank's device in the job's process group, for a mesh run;
    raises outside ``torch.distributed.run``."""
    from .parallel.bootstrap import init_distributed

    dev = init_distributed(backend=args.backend,
                           device=None if cfg.device == "cuda"
                           else cfg.device)
    if dev is None:
        ranks = math.prod(cfg.mesh_shape)
        raise RuntimeError(
            f"--mesh {args.mesh} runs one process per rank: launch it as "
            f"python -m torch.distributed.run --nproc-per-node {ranks} -m "
            f"zkodst_tpu_torch prove --mesh {args.mesh}")
    return dev


def cmd_prove(args) -> int:
    import torch.distributed as dist

    from . import api

    cfg = _config(args)
    dev = cfg.device if cfg.mesh_shape is None else _join(cfg, args)
    try:
        mesh, axis = cfg.make_mesh()
        lead = mesh is None or mesh.rank == 0
        pipe = api.setup_blake2f(k=cfg.k, n_inst=cfg.n_inst,
                                 rounds=cfg.rounds, cache_dir=cfg.cache_dir,
                                 echo=cfg.echo and lead,
                                 scheme=cfg.commitment, device=dev,
                                 mesh=mesh, mesh_axis=axis or "x")
        h, m, t, f = api.eip152_inputs(pipe.n_inst)
        mode = args.transcript_mode
        proof, inst = pipe.prove(h, m, t, f, seed=cfg.seed,
                                 transcript_mode=mode)
        ok = pipe.verify(inst, proof, transcript_mode=mode)
    finally:
        if cfg.mesh_shape is not None:
            dist.destroy_process_group()
    if lead:
        print(pipe.metrics.to_json())
        print(json.dumps({"prove_spans": pipe.metrics.tree()}))
        print(json.dumps({"proof_bytes": len(proof), "verified": bool(ok)}))
    return 0 if ok else 1


def cmd_mock(args) -> int:
    from . import api
    from .circuit import mock

    cfg = _config(args)
    built = api.blake2f_circuit.Blake2fCircuit(
        k=cfg.k, n_inst=cfg.n_inst, rounds=cfg.rounds, device=cfg.device)
    adv, inst = built.witness(*api.eip152_inputs(cfg.n_inst))
    fails = mock.check(built.circ, adv, inst, built.device)
    for fl in fails:
        print(fl, file=sys.stderr)
    print(json.dumps({"constraints_ok": not fails, "k": cfg.k,
                      "instances": cfg.n_inst}))
    return 1 if fails else 0


def cmd_vectors(args) -> int:
    import numpy as np
    import torch

    from .kernels import blake2 as kblake2
    from .ops import blake2, u64
    from .utils.device import resolve
    from .utils.timing import upload

    dev = resolve(args.device)

    def pairs(words):
        return upload(torch.from_numpy(u64.from_ints(words).astype(np.int64)),
                      dev)[None]

    bad = 0
    for v in blake2.EIP152_VECTORS:
        if "error" in v:
            try:
                blake2.eip152_decode(v["input"])
                bad += 1
                status = "FAIL (accepted malformed input)"
            except ValueError:
                status = "ok (rejected)"
        elif v["expected"] is None:
            status = "ok (decode-only)"
        else:
            rounds, h, m, t, f = blake2.eip152_decode(v["input"])
            out = kblake2.blake2f_compress(pairs(h), pairs(m), pairs(t),
                                           upload(torch.tensor([f]), dev),
                                           rounds)
            got = b"".join(int(x).to_bytes(8, "little")
                           for x in u64.to_ints(out[0])).hex()
            status = "ok" if got == v["expected"] else f"FAIL: {got}"
            bad += status != "ok"
        print(f"vector {v['n']}: {status}")
    return 1 if bad else 0


def cmd_bench(args) -> int:
    from . import bench

    return bench.main(args.device, args.cache_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkodst_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("prove", cmd_prove), ("mock", cmd_mock),
                     ("vectors", cmd_vectors)):
        p = sub.add_parser(name)
        _add_common(p)
        p.set_defaults(fn=fn)
    p = sub.add_parser("bench")
    p.add_argument("--cache-dir", default=".zkodst_cache")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    p.set_defaults(fn=cmd_bench)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
