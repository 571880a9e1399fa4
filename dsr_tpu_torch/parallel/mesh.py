"""Process groups and the device mesh over the (data, model, subband) axes.

Counterpart of `dsr_tpu/parallel/mesh.py` on `torch.distributed`: one
process a device, NCCL between CUDA devices and gloo between CPU processes,
chosen by the device the caller names.  A `DeviceMesh` names its axes by
`AXES`; `mesh.get_group(axis)` is the process group of this rank's line
along an axis, `mesh.get_local_rank(axis)` its coordinate there.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dsr_tpu_torch.config import MeshConfig
from dsr_tpu_torch.utils.device import resolve

AXES = ("data", "model", "subband")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of the mesh live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(cfg: MeshConfig | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` over the logical axes.

    With cfg=None every rank goes to `data` (utterance-batch parallelism,
    the dominant axis for DSR workloads).  A config that covers fewer ranks
    than the world takes ranks [0, n), as the JAX package takes the first n
    devices; the other ranks hold no coordinate in it.  Every rank of the
    world calls this (subgroups are created collectively).  The process
    group must already exist (`initialize_distributed`) with the backend
    of `device_type`: NCCL for `cuda`, gloo for `cpu`.
    """
    resolve(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise ValueError(f"make_mesh: a {device_type} mesh needs the {BACKENDS[device_type]} "
                         f"backend, the process group has {backend}")
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(data=world)
    n = cfg.num_devices
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    ranks = torch.arange(n).reshape(cfg.data, cfg.model, cfg.subband)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None,
                           heartbeat_timeout_s: float | None = None, device: str = "cuda",
                           always: bool = False) -> None:
    """Join the process group: NCCL when `device` is `cuda`, gloo when it is
    `cpu`, never chosen by what happens to be available.

    `coordinator` is an `init_method` URL (`tcp://host:port`, or
    `file:///path` for a FileStore rendezvous).  `heartbeat_timeout_s`
    bounds how long a dead peer can stall a collective before it raises
    (the process group's timeout).  A no-op for one process unless
    `always` asks for a group of one.  On `cuda` each process takes the
    card `process_id % device_count`.
    """
    if not (num_processes and (num_processes > 1 or always)):
        return
    dev = resolve(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"initialize_distributed: no backend for device {device!r}")
    kw = {}
    if heartbeat_timeout_s is not None:
        kw["timeout"] = timedelta(seconds=heartbeat_timeout_s)
    if dev.type == "cuda":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(BACKENDS[dev.type], init_method=coordinator,
                            world_size=num_processes, rank=process_id, **kw)
