"""Multi-process runtime: torch.distributed init, global meshes, rank devices.

Counterpart of bundletrack_tpu/parallel/distributed.py.  The model is
SPMD, as JAX's multi-controller runtime is: one process per rank, every
rank runs the same program, one card per rank when the world fits the
cards.  A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions ("stream", "pairs", "data", "model"); each named axis is one
process group, and the port calls its collectives explicitly
(ops/collectives.py) where the JAX package's shard_map bodies psum.

Stream-parallel tracking needs no communication between ranks; the
pair-sharded BA all-reduces its normal equations once per GN iteration;
training all-reduces gradients over "data" and activations over "model".

`spawn_ranks` runs a function on `world` local ranks (torch.multiprocessing,
a file:// rendezvous) and fails when any rank fails or outlives its time.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", world_rank()))


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when the caller gives one (e.g. "cpu"),
    else cuda:(local rank % visible cards).  Without a card it raises
    instead of quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the process group (a no-op for one process); returns this
    rank's device (`rank_device(device)`).

    From the arguments, or, where they are None, from torchrun's
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT environment.
    `coordinator_address` is "host:port" (tcp) or a full init URL
    ("tcp://...", "file://...").  `backend=None` is "nccl" on the card and
    "gloo" on the CPU.  NCCL refuses two ranks on one card, so a host with
    more ranks than visible cards needs backend="gloo", asked for: it
    raises ValueError otherwise.  Every collective ends with an error after
    `timeout_s` instead of hanging.
    """
    n = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    dev = rank_device(device) if n <= 1 else None
    if n <= 1:
        return dev
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if device is None and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(rank)  # one host: the local rank is the rank
    dev = rank_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl":
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        if ranks_here > torch.cuda.device_count():
            raise ValueError(
                f"{ranks_here} ranks on a host with {torch.cuda.device_count()} visible card(s): NCCL refuses "
                "two ranks on one card; pass backend='gloo' to share cards"
            )
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()  # DeviceMesh then keeps this device instead of picking one by rank
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(axis_sizes: dict):
    """A named mesh over the whole world, e.g. make_mesh({"stream": 8}).

    The product of the sizes must equal the world size (ValueError): the
    JAX package may take a prefix of the devices, a process group cannot
    leave ranks out of an SPMD program.  The mesh's device type is "cuda"
    for an NCCL world and "cpu" for gloo (gloo moves even card tensors
    through host memory)."""
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = 1
    for s in sizes:
        n *= s
    if n != world_size():
        raise ValueError(f"mesh {dict(zip(names, sizes))} has {n} ranks, the world {world_size()}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call initialize_multihost first")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def axis_group(mesh, axis: Optional[str]):
    """The process group of one named mesh axis (None for no mesh or axis)."""
    if mesh is None or axis is None:
        return None
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"axis {axis!r} not in mesh axes {mesh.mesh_dim_names}")
    return mesh.get_group(axis)


def global_fleet_mesh():
    """1-D mesh over every rank for stream-parallel fleets."""
    return make_mesh({"stream": world_size()})


def global_train_mesh(model_parallel: int = 1):
    """(data, model) mesh: `model_parallel` consecutive ranks per model
    shard, so a model group stays within a host when ranks are numbered
    host by host, and data parallelism spans hosts."""
    n = world_size()
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the world {n}")
    return make_mesh({"data": n // model_parallel, "model": model_parallel})


def local_stream_slice(num_streams: int, mesh=None) -> slice:
    """The global stream indices this rank owns: its block of the streams by
    its coordinate along the "stream" axis of `mesh`, or by its rank in the
    world without a mesh.  The streams must divide evenly."""
    if mesh is None:
        n, i = world_size(), world_rank()
    else:
        n, i = mesh.size(mesh.mesh_dim_names.index("stream")), mesh.get_local_rank("stream")
    if num_streams % n:
        raise ValueError(f"{num_streams} streams do not divide over {n} ranks")
    per = num_streams // n
    return slice(i * per, (i + 1) * per)


def _rank_entry(rank, fn, world, rdv, backend, device, timeout_s, args):
    initialize_multihost(f"file://{rdv}", world, rank, backend=backend, device=device, timeout_s=timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), backend: Optional[str] = None, device=None,
                timeout_s: float = DEFAULT_TIMEOUT_S, join_s: Optional[float] = None) -> None:
    """Run fn(rank, *args) on `world` spawned ranks joined in one process
    group (file:// rendezvous in a temporary directory), and wait.

    A rank's exception is raised here; ranks still alive after `join_s`
    seconds (default: timeout_s + 60) are killed and this raises
    TimeoutError.  `fn` must be importable by name (a module-level
    function): spawned ranks import it afresh."""
    import torch.multiprocessing as mp

    join_s = timeout_s + 60.0 if join_s is None else join_s
    with tempfile.TemporaryDirectory(prefix="bt_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world, os.path.join(tmp, "rendezvous"), backend, device, timeout_s, args),
            nprocs=world, join=False, start_method="spawn",
        )
        try:
            deadline = datetime.datetime.now() + datetime.timedelta(seconds=join_s)
            while not ctx.join(timeout=1.0):
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"ranks still running after {join_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
