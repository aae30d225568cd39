"""Production meshes as ``DeviceMesh``es (the counterpart of
``repro.launch.mesh``), and the process groups they are built on.

A mesh needs a default process group of its size, which the caller
provides: :func:`fake_group` for the dry run (PyTorch's ``"fake"``
backend, whose collectives move nothing, at 256 or 512 ranks in one
process), :func:`local_group` on one card (``nccl`` at world size 1 over an
in-process store, so no network).  A process holds one default group at a
time; each context manager destroys its group on exit.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "shape_mesh", "fake_group",
           "local_group"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """16×16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def shape_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
               device_type: str = "cpu"):
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default process group of ``world_size`` ranks on the ``"fake"``
    backend (this process is rank 0; collectives return without moving
    data), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_group(device: str = "cuda"):
    """A one-rank default group on ``device`` (``nccl`` on a card, ``gloo``
    on the CPU) over an in-process store, destroyed on exit."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
