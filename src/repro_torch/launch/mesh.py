"""Mesh construction: ``torch.distributed`` ``DeviceMesh``es with the
reference's axis names.

Functions, not module constants: importing initialises no process
group. Production: 256 ranks as ``(data=16, model=16)``, or 2 pods x
256 as ``(pod=2, data=16, model=16)``. In one process with no group
yet, the production and host meshes start one themselves: the ``fake``
backend at the production world size (a dry-run: every collective
returns at once and moves nothing), a one-rank ``gloo`` group for the
host mesh. :func:`make_mesh` spans the ranks of a group the caller has
started (one process a card under NCCL; processes on the CPU under
gloo).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def _ensure_group(backend: str, world: int) -> None:
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"running; this mesh needs {world}")
        return
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=world)


def _mesh(device_type: str, shape: Tuple[int, ...],
          names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` with a
    ``pod`` axis. Without a process group, starts the ``fake`` backend
    at 256 or 512 ranks, as rank 0: the dry-run's mesh."""
    shape, names = MULTI if multi_pod else SINGLE
    world = 1
    for n in shape:
        world *= n
    _ensure_group("fake", world)
    return _mesh("cpu", shape, names)


def make_host_mesh():
    """The one-rank ``(1, 1)`` mesh for CPU smoke runs (same axis
    names); starts a one-rank gloo group if none runs."""
    _ensure_group("gloo", 1)
    return _mesh("cpu", (1, 1), ("data", "model"))


def make_mesh(data: int = 1, model: Optional[int] = None):
    """``(data, model)`` over the ranks of the running group; ``model``
    defaults to the world size over ``data``. Under NCCL, one rank a
    card and the mesh on ``cuda``; under gloo or the fake backend, on
    the CPU. Raises without a group, or under NCCL without CUDA."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running process group "
                           "(one rank a process)")
    cuda = "nccl" in dist.get_backend()
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: an NCCL group, and torch sees no GPU")
    world = dist.get_world_size()
    model = world // data if model is None else model
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) over {world} ranks")
    return _mesh("cuda" if cuda else "cpu", (data, model), ("data", "model"))
