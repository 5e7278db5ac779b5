"""Device meshes of the port (``repro.launch.mesh``) over
``torch.distributed``: one process per rank, each rank one device (a card
under NCCL, or the CPU under gloo).

A :class:`Mesh` wraps a ``torch.distributed.device_mesh.DeviceMesh`` and
reads like the reference's ``jax.sharding.Mesh`` where the port needs it:
``axis_names`` and ``shape`` (axis name -> size). Ranks are laid out
row-major over the axes, as ``jax.make_mesh`` lays out devices: on a
``(4, 2)`` mesh over ``("data", "model")`` rank ``r`` sits at data index
``r // 2`` and model index ``r % 2``.

The backend follows the device the caller asks for: NCCL for ``"cuda"``,
gloo for ``"cpu"``. Nothing here chooses by what is installed.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the paper's meshes: 16x16 on one pod (256
    chips) or 2x16x16 over two pods (512 chips). Given as shapes only:
    the port runs on one host."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_process_group(*, device="cuda", rank: int = 0, world_size: int = 1,
                       store_path: str = None) -> None:
    """The default process group of this rank, over a ``FileStore`` (no
    socket for the rendezvous): ``store_path`` is a file every rank names
    alike; for one process (world 1) a file in a fresh temporary directory,
    removed at exit. On ``"cuda"`` the rank takes card ``rank`` of this
    host first."""
    dev = resolve_device(device)
    if store_path is None:
        if world_size != 1:
            raise ValueError(f"a group of {world_size} ranks needs a "
                             f"store_path that every rank names")
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        store_path = os.path.join(tmp, "store")
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[dev.type],
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)


class Mesh:
    """A named mesh over every rank of the default process group.

    ``device_mesh`` is the ``DeviceMesh``; ``axis_names`` and ``shape``
    mirror the reference's mesh; ``group(axis)`` is the process group of
    this rank's line along ``axis``; ``subgroup(axis, size)`` the group of
    ``size`` consecutive ranks of that line holding this rank, made for
    every line once per mesh (``new_group`` is called by every rank for
    every group, in one order) and kept."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(
            self.axis_names, device_mesh.mesh.shape))
        self._subgroups: Dict[Tuple[str, int], object] = {}
        # read once, so that no step reads the rank tensor (a dry run's
        # steps run under a fake-tensor mode)
        self._by_axis = {a: self._read_lines(d)
                         for d, a in enumerate(self.axis_names)}

    def axis_index(self, axis: str) -> int:
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def _read_lines(self, d: int) -> List[List[int]]:
        ranks = self.device_mesh.mesh.movedim(d, -1)
        return ranks.reshape(-1, ranks.shape[-1]).tolist()

    def _lines(self, axis: str) -> List[List[int]]:
        """Global ranks of every line of the mesh along ``axis``, each line
        in axis order; lines in row-major order of the other axes."""
        return self._by_axis[axis]

    def line(self, axis: str) -> List[int]:
        """Global ranks of this rank's line along ``axis``, in axis order."""
        me = dist.get_rank()
        return next(line for line in self._lines(axis) if me in line)

    def subgroup(self, axis: str, size: int):
        key = (axis, size)
        if key not in self._subgroups:
            n = self.shape[axis]
            if n % size:
                raise ValueError(f"{n} ranks along {axis!r} do not split "
                                 f"into groups of {size}")
            me, mine = dist.get_rank(), None
            for line in self._lines(axis):
                for i in range(0, n, size):
                    ranks = line[i:i + size]
                    group = dist.new_group(ranks)
                    if me in ranks:
                        mine = group
            self._subgroups[key] = mine
        return self._subgroups[key]


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device="cuda") -> Mesh:
    """A mesh of ``shape`` over axes ``names`` on ``device``'s type. Uses
    the default process group when one is up (its backend must be the
    device's); otherwise starts a one-rank group, which takes a mesh of
    one rank only."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        init_process_group(device=dev, world_size=math.prod(shape))
    elif dist.get_backend() != backend:
        raise ValueError(f"a {dev.type} mesh needs the {backend} backend; "
                         f"the process group runs {dist.get_backend()}")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(dev.type, tuple(shape),
                                 mesh_dim_names=tuple(names)))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                   device="cuda") -> Mesh:
    """A small mesh: (pod, data, model) when ``pod``, else (data, model)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device=device)
    return make_mesh((data, model), ("data", "model"), device=device)


def single_device_mesh(device="cuda") -> Mesh:
    """The 1 x 1 (data, model) mesh of one rank."""
    return make_mesh((1, 1), ("data", "model"), device=device)
