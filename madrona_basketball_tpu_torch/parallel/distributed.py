"""Multi-process bring-up over `torch.distributed` (port of
`madrona_basketball_tpu/parallel/distributed.py:22-70`).

The JAX package runs one SPMD program over a device mesh and joins hosts
with `jax.distributed.initialize()`.  The port runs one process per GPU,
PyTorch's idiom: every process calls `init_distributed`, which joins the
process group (NCCL on the card, gloo on the CPU), and
`parallel/mesh.py::make_mesh` then names the rank's share of the worlds.

Typical launch on one host with k GPUs (the same command in every
process; torchrun sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
LOCAL_RANK):

    torchrun --nproc-per-node k -m madrona_basketball_tpu_torch.cli \\
        --data-parallel --distributed ...
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def backend_for(device) -> str:
    """The process group's backend for `device`: NCCL for CUDA, gloo for
    the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device}")


def _set_local_device(device, rank: int):
    """One GPU per process: the device's own index, else LOCAL_RANK
    (torchrun's), else the rank modulo the visible GPUs, becomes this
    process's current CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not "
                           "available")
    if dev.index is None:
        n = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank % n)))
    torch.cuda.set_device(dev)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> int:
    """Join the process group; returns the global GPU count, the world
    size (each process holds one GPU).

    * Already initialized: a no-op that returns the group's size.
    * coordinator_address ("host:port"), num_processes and process_id
      given: joins over TCP at that address.  Giving some of them but
      not all raises ValueError.
    * Nothing given: torchrun's MASTER_ADDR, MASTER_PORT, RANK and
      WORLD_SIZE (`env://`); a partial set of them raises ValueError.
      With none of them set it warns and continues as one process,
      uninitialized, and returns 1, as the JAX function continues
      single-process when no coordinator is found.

    The backend is NCCL when `device` is CUDA and gloo when it is the
    CPU; on CUDA the process's GPU (LOCAL_RANK, else rank modulo the
    visible GPUs) becomes its current device first."""
    if dist.is_initialized():
        return dist.get_world_size()
    backend = backend_for(device)
    explicit = (coordinator_address, num_processes, process_id)
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise ValueError(
                "init_distributed: coordinator_address, num_processes and "
                "process_id must be given together, got "
                f"{coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r}")
        _set_local_device(device, process_id)
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        return dist.get_world_size()
    present = [k for k in _ENV if k in os.environ]
    if not present:
        warnings.warn("torch.distributed not initialized (no coordinator "
                      "given and no MASTER_ADDR / MASTER_PORT / RANK / "
                      "WORLD_SIZE in the environment); continuing "
                      "single-process", stacklevel=2)
        return 1
    if len(present) != len(_ENV):
        missing = [k for k in _ENV if k not in os.environ]
        raise ValueError(f"init_distributed: the environment sets "
                         f"{present} but not {missing}")
    _set_local_device(device, int(os.environ["RANK"]))
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()


def init_single_process(device="cuda") -> int:
    """A process group of this process alone (world size 1, an in-memory
    store, no network): the `--data-parallel` run on one visible GPU, or
    on the CPU, started without torchrun.  Its collectives run for real
    (NCCL on the card).  Returns 1."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    _set_local_device(device, 0)
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1)
    return 1
