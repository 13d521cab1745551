"""Process-group bootstrap and the prover's mesh of ranks.

Counterpart of ``zkodst_tpu/parallel/bootstrap.py`` on
``torch.distributed``. The reference is single-controller: one process
drives every device through ``shard_map``. The port is SPMD: one process a
rank, each holding a device, every rank running the same ``create_proof``
on replicated columns; only the sharded operations of this package take
the rank's shard, compute it with the port's kernels and exchange it.

Call :func:`init_distributed` once per rank process (a no-op outside
``torch.distributed.run``), then :func:`make_mesh` for the :class:`Mesh`
the prover shards over (``create_proof(..., mesh=mesh, mesh_axis=...)``).
Axis convention: ("host", "chip"); an axis may be one name or a tuple of
names in the mesh's order, whose ranks are then the flattened product, so a
2-D mesh needs no special casing: ``mesh_axis=("host", "chip")``.

Every rank must call each collective of a mesh in the same order: no
rank-dependent branch may sit between two of them.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.device import resolve

AxisName = Union[str, Sequence[str]]


def init_distributed(backend: Optional[str] = None, device=None):
    """Join the job's process group from the ``torch.distributed.run``
    variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, and
    ``MASTER_ADDR`` and ``MASTER_PORT`` for the rendezvous). Without
    ``WORLD_SIZE`` this is a no-op that returns None, so it is safe to call
    unconditionally; otherwise it returns the rank's device.

    The device defaults to ``cuda:LOCAL_RANK`` and must exist: ranks are
    never mapped onto cards silently. The backend is NCCL for a CUDA device
    and gloo for the CPU unless `backend` names one; two ranks that share
    one card pass ``device="cuda:0"`` and ``backend="gloo"``."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} asks for cuda:{index} but this host has "
                f"{torch.cuda.device_count()} CUDA device(s): launch at most "
                "one rank per card, or name a shared device with "
                "backend='gloo'")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://", world_size=world, rank=rank)
    return dev


class Mesh:
    """The job's ranks as a grid of `shape` with named axes, and a process
    group per axis.

    Rank r sits at ``np.unravel_index(r, shape)``. An axis — one name, or
    a tuple of names in the mesh's order — groups the ranks that share
    every other coordinate; along it a rank's index is its coordinates on
    those axes flattened, which is its rank in that group. ``shape`` maps
    each name to its extent, as a JAX mesh's does.

    The collectives return their result on the input's device. Over gloo
    they stage CUDA tensors through host buffers (chosen by the backend,
    not on a failure): gloo is a host transport. NCCL takes them where they
    are."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group: call parallel.bootstrap.init_distributed "
                "in each rank (launch with python -m torch.distributed.run)")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                             f"ranks, the job has {world}")
        self.axis_names = tuple(axis_names)
        self.devices_shape = tuple(shape)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.rank = dist.get_rank()
        self.staged = dist.get_backend() == "gloo"
        self._coords = tuple(int(c) for c in
                             _unravel(self.rank, self.devices_shape))
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}, "
                f"{dist.get_backend()})")

    def _names(self, axis: AxisName) -> Tuple[str, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        pos = [self.axis_names.index(a) for a in names
               if a in self.axis_names]
        if len(pos) != len(names) or pos != sorted(set(pos)):
            raise ValueError(f"axis {axis!r} is not one of {self.axis_names} "
                             "or a tuple of them in the mesh's order")
        return names

    def size(self, axis: AxisName) -> int:
        return math.prod(self.shape[a] for a in self._names(axis))

    def index(self, axis: AxisName) -> int:
        """This rank's position along `axis` (its shard's number)."""
        idx = 0
        for a in self._names(axis):
            i = self.axis_names.index(a)
            idx = idx * self.devices_shape[i] + self._coords[i]
        return idx

    def shard(self, x: torch.Tensor, axis: AxisName,
              dim: int = 0) -> torch.Tensor:
        """This rank's block of `x` along `dim` (a view): the dimension is
        cut into D equal blocks and block ``index(axis)`` kept. Raises if D
        does not divide it."""
        D, n = self.size(axis), x.shape[dim]
        if n % D:
            raise ValueError(f"{n} rows do not split over {D} shards")
        return x.narrow(dim, self.index(axis) * (n // D), n // D)

    def group(self, axis: AxisName):
        """The process group of this rank along `axis`. Made on first use
        with every other group of that axis, by every rank in one order
        (``dist.new_group`` is collective over the whole job)."""
        names = self._names(axis)
        if names not in self._groups:
            if len(names) == len(self.axis_names):
                self._groups[names] = dist.group.WORLD
            else:
                along = [self.axis_names.index(a) for a in names]
                rest = [i for i in range(len(self.axis_names))
                        if i not in along]
                for other in itertools.product(
                        *(range(self.devices_shape[i]) for i in rest)):
                    ranks = []
                    for mine in itertools.product(
                            *(range(self.devices_shape[i]) for i in along)):
                        coords = [0] * len(self.axis_names)
                        for i, c in zip(rest, other):
                            coords[i] = c
                        for i, c in zip(along, mine):
                            coords[i] = c
                        ranks.append(_ravel(coords, self.devices_shape))
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[names] = pg
        return self._groups[names]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def all_gather(self, t: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """Every shard's `t` (at least 1-D) along `axis`, stacked:
        (D, *t.shape)."""
        D = self.size(axis)
        x = self._wire(t)
        # one concatenated (D·N, …) output: gloo refuses a stacked one;
        # all_gather_single is the name of newer torch releases
        out = torch.empty((D * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        gather(out, x, group=self.group(axis))
        return out.view((D,) + tuple(t.shape)).to(t.device)

    def all_to_all(self, t: torch.Tensor, axis: AxisName) -> torch.Tensor:
        """t's dim 0 cut into D equal chunks, chunk d sent to shard d;
        returns the chunks received, chunk s from shard s, in t's shape."""
        x = self._wire(t)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axis))
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank of the mesh."""
        x = self._wire(t).clone()
        dist.broadcast(x, 0, group=self.group(self.axis_names))
        return x.to(t.device)

    def barrier(self) -> None:
        """Returns once every rank of the mesh has reached it."""
        dev = "cpu" if self.staged else torch.cuda.current_device()
        self.all_gather(torch.zeros(1, dtype=torch.int32, device=dev),
                        self.axis_names)


def _unravel(r: int, shape: Tuple[int, ...]):
    out = []
    for d in reversed(shape):
        out.append(r % d)
        r //= d
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    r = 0
    for c, d in zip(coords, shape):
        r = r * d + c
    return r


def make_mesh(shape: Tuple[int, ...],
              axis_names: Tuple[str, ...] = ("host", "chip")) -> Mesh:
    """The prover's mesh over the job's ranks: prod(shape) must equal the
    world size. A 1-D `shape` with more than one name takes the last."""
    if len(shape) == 1 and len(axis_names) != 1:
        axis_names = (axis_names[-1],)
    return Mesh(tuple(shape), tuple(axis_names))


def axis_size(mesh: Mesh, axis: AxisName) -> int:
    """Mesh extent of one axis name or the product over a tuple of
    names."""
    return mesh.size(axis)
