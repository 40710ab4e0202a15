"""Device meshes of the serving path (counterpart of
``pilosa_tpu/parallel/mesh.py``).

One axis, ``shards``, carries this workload's parallelism: a field's
stack is cut along its shard axis into contiguous slices, one a device
(``parallel/sharded.py`` :class:`ShardedStack`), and each kernel wrapper
launches its hand kernel once per slice and reduces the slices' outputs
(the reference's shard-to-node placement, cluster.go:858-934, made
static). torch has no ``Mesh``; :class:`ServingMesh` is the small value
type in its place: an ordered tuple of devices, with the rank of the
process that owns each.

* :func:`serving_mesh` covers this process's CUDA devices (capped by
  :func:`configure_serving`) and is None on a host with one device, as in
  JAX, so a one-card host runs the plain single-device path.
* ``configure_serving(devices=[...])`` sets the mesh's devices outright:
  ``[cuda:0] * 4`` or ``[cpu] * 8`` give a mesh of 4 or 8 slices on one
  device (the port's counterpart of the virtual devices that
  ``--xla_force_host_platform_device_count`` gives JAX). Only an explicit
  call sets it; there is no environment variable.
* :func:`init_multihost` joins ``torch.distributed`` and returns the
  global mesh over every rank's local devices in rank order; on it the
  kernel wrappers follow their in-process reduce with an ``all_reduce``
  of the int64 totals (:func:`mesh_spans_processes`).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch


class ServingMesh(NamedTuple):
    """An ordered tuple of devices on one ``("shards",)`` axis, and the
    rank of the process that owns each (all this process's rank on a
    local mesh). ``spans`` is True for the global mesh of a job of more
    than one process (:func:`init_multihost`)."""

    devices: tuple
    processes: tuple
    spans: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple:
        return ("shards",)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def local_positions(self) -> list[int]:
        """Positions on the mesh of the devices this process owns."""
        me = _rank()
        return [i for i, p in enumerate(self.processes) if p == me]


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_mesh(devices) -> ServingMesh:
    """A mesh of this process's ``devices``, in order (a device may repeat)."""
    devs = tuple(torch.device(d) for d in devices)
    return ServingMesh(devs, (_rank(),) * len(devs))


def mesh_shape_for(n_devices: int) -> tuple[int, int]:
    """(shards, rows) axis sizes: every device on the ``shards`` axis (the
    JAX package dropped its rows factor; the pair stays for its callers)."""
    return n_devices, 1


_lock = threading.Lock()
_serving_max_devices: int | None = None
_serving_devices: tuple | None = None
_serving_mesh: ServingMesh | None = None


def local_devices() -> list[torch.device]:
    """This process's devices: those :func:`configure_serving` set, else
    every CUDA device (capped at its ``max_devices``), else the CPU."""
    with _lock:
        if _serving_devices is not None:
            return list(_serving_devices)
        cap = _serving_max_devices
    if torch.cuda.is_available():
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    return devs if cap is None else devs[:cap]


def default_mesh(n_devices: int | None = None) -> ServingMesh:
    """A local mesh over the first ``n_devices`` of :func:`local_devices`
    (all of them by default), one device included."""
    devs = local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return local_mesh(devs)


def configure_serving(max_devices: int | None, *, devices=None) -> None:
    """Cap the serving mesh at the first ``max_devices`` devices (None:
    all), or, with ``devices``, make it exactly those devices in that
    order (a device may repeat: k slices on one card). ``configure_serving
    (None)`` returns to the default."""
    global _serving_max_devices, _serving_devices, _serving_mesh
    devs = None if devices is None else tuple(torch.device(d) for d in devices)
    if devs is not None and len({d.type for d in devs}) > 1:
        raise ValueError(f"a serving mesh of one device type, got {devs}")
    with _lock:
        _serving_max_devices = max_devices
        _serving_devices = devs
        _serving_mesh = None


def serving_configured() -> bool:
    """Whether :func:`configure_serving` set the mesh's devices outright."""
    with _lock:
        return _serving_devices is not None


def serving_mesh() -> ServingMesh | None:
    """The ``("shards",)`` mesh the serving executor lays its stacks over:
    this process's devices (:func:`local_devices`), each owning a
    contiguous slice of shards. None on a one-device host (the plain
    single-device path is the faster one there)."""
    global _serving_mesh
    devs = local_devices()
    if len(devs) <= 1:
        return None
    with _lock:
        if _serving_mesh is None or list(_serving_mesh.devices) != devs:
            _serving_mesh = local_mesh(devs)
        return _serving_mesh


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> ServingMesh:
    """Join this process to a ``torch.distributed`` job and return the
    global mesh: every rank's local devices (:func:`local_devices`), in
    rank order, so the global shard order is process-major.

    ``coordinator_address`` is the process group's init method
    (``tcp://host:port`` or ``file://path``; a bare ``host:port`` gets
    ``tcp://``). ``backend`` defaults to ``"nccl"`` when the local devices
    are CUDA devices and ``"gloo"`` on the CPU; ``"gloo"`` also runs
    collectives of CUDA tensors, and lets two ranks share one card, which
    NCCL refuses. With no address and no process count (a one-process
    job), nothing is joined and the result is :func:`default_mesh`. A
    group that fails to form raises."""
    dist = torch.distributed
    if coordinator_address is None and num_processes is None:
        return default_mesh()
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost: num_processes and process_id go together")
    devs = local_devices()
    if backend is None:
        backend = "nccl" if devs[0].type == "cuda" else "gloo"
    if not dist.is_initialized():
        addr = coordinator_address
        if addr is not None and "://" not in addr:
            addr = f"tcp://{addr}"
        if backend == "nccl":
            torch.cuda.set_device(devs[0])
        dist.init_process_group(
            backend, init_method=addr, world_size=num_processes, rank=process_id
        )
    world = dist.get_world_size()
    mine = [(d.type, d.index) for d in devs]
    every: list = [None] * world
    dist.all_gather_object(every, mine)
    devices, processes = [], []
    for rank, theirs in enumerate(every):
        for typ, index in theirs:
            devices.append(torch.device(typ, index) if index is not None else torch.device(typ))
            processes.append(rank)
    return ServingMesh(tuple(devices), tuple(processes), spans=world > 1)


def mesh_spans_processes(mesh: ServingMesh | None) -> bool:
    """Whether ``mesh`` includes other processes' devices: the global mesh
    of :func:`init_multihost` with a world size above 1. The stacks laid
    over it hold only this process's slices, and the kernel wrappers
    reduce their totals across the processes."""
    return mesh is not None and mesh.spans
