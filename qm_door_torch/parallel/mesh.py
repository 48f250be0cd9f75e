"""Device-mesh helpers for scenario-parallel batched MPC (port of
qm_door_tpu/parallel/mesh.py).

The scale-out axis is the scenario batch: B independent MPC problems solved
lock-step, split over a 1-D ``torch.distributed`` DeviceMesh whose one
dimension is named ``"scenario"``. A process drives one device (a CUDA card
on NCCL, or the CPU on gloo), so the mesh's size is the process group's. A
batch on the mesh is a ``DTensor`` placed ``Shard(0)``: each process holds
its B / size scenarios. Data every scenario shares is placed ``Replicate()``.
Nothing in the solver changes: ``parallel/batched.py:BatchedMpc`` with a
mesh runs each step on the process's own shard, so the solve path has no
collective; only user-level reductions (a fleet mean) communicate.

A tree here is a tensor, or a tuple, list, dict or dataclass of them (as
StageData); None leaves stay None.
"""
from __future__ import annotations

import dataclasses
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import resolve_device

SCENARIO_AXIS = "scenario"
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def tree_map(fn, tree):
    """``fn`` applied to every tensor leaf of ``tree``, its structure kept."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"no tensor tree: {type(tree).__name__}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _local_device(mesh: DeviceMesh) -> torch.device:
    """The device this process drives on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def scenario_mesh(n_devices=None, device=None) -> DeviceMesh:
    """The 1-D scenario mesh over the first ``n_devices`` processes of the
    default process group (all of them by default), each on its device:
    CUDA unless ``device="cpu"``. Without a process group it starts one of
    a single process (NCCL on CUDA, gloo on the CPU, a free local port)."""
    kind = resolve_device(device).type
    if not dist.is_initialized():
        dist.init_process_group(_BACKENDS[kind], init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    size = dist.get_world_size()
    n = size if n_devices is None else n_devices
    if not 0 < n <= size:
        raise ValueError(f"scenario_mesh: {n} devices of a process group of {size}")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(kind, torch.arange(n), mesh_dim_names=(SCENARIO_AXIS,))


def check_divides(batch: int, mesh: DeviceMesh) -> None:
    """Raise unless a batch of ``batch`` scenarios splits evenly over ``mesh``."""
    if batch % mesh.size():
        raise ValueError(f"a batch of {batch} scenarios does not split over "
                         f"{mesh.size()} devices of the {SCENARIO_AXIS!r} mesh")


def local_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This process's rows of a whole batch ``x``, on its device. Raises
    unless the batch divides by the mesh's size."""
    check_divides(x.shape[0], mesh)
    b = x.shape[0] // mesh.size()
    rank = mesh.get_local_rank()
    return x[rank * b:(rank + 1) * b].to(_local_device(mesh))


def shard_batch(tree, mesh: DeviceMesh):
    """Place a tree with a leading scenario axis onto the mesh (sharded dim
    0): every process passes the whole batch and keeps its own rows. Raises
    unless the batch divides by the mesh's size."""
    return tree_map(lambda x: DTensor.from_local(local_rows(x, mesh), mesh, [Shard(0)],
                                                 run_check=False, shape=x.shape,
                                                 stride=x.stride()), tree)


def replicate(tree, mesh: DeviceMesh):
    """Place a tree whole on every device of the mesh."""
    dev = _local_device(mesh)
    return tree_map(lambda x: DTensor.from_local(x.to(dev), mesh, [Replicate()],
                                                 run_check=False), tree)


def multihost_mesh(coordinator_address=None, num_processes=None, process_id=None,
                   device=None) -> DeviceMesh:
    """Multi-process scenario mesh. Call once per process before any other
    distributed use:

        mesh = multihost_mesh("host0:1234", num_processes=2, process_id=rank)

    With a coordinator it starts the process group (once) over TCP at that
    address; on a single process it degrades to :func:`scenario_mesh`. Each
    process then feeds its own shard (:func:`from_process_local`); the
    solves stay local, and collectives appear only in user-level
    reductions such as fleet statistics."""
    if coordinator_address is not None and not dist.is_initialized():
        dist.init_process_group(_BACKENDS[resolve_device(device).type],
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return scenario_mesh(device=device)


def from_process_local(mesh: DeviceMesh, local_batch):
    """Assemble a global scenario batch from per-process shards (each
    process passes its own rows, all of one size)."""
    dev = _local_device(mesh)
    return tree_map(lambda x: DTensor.from_local(x.to(dev), mesh, [Shard(0)], run_check=False),
                    local_batch)
