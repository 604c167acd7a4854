"""Multi-process bootstrap (counterpart of ``pyrayt_tpu.parallel.distributed``).

The JAX package joins JAX's coordinator service; the port joins a
``torch.distributed`` process group, one process per rank.  Every rank
calls :func:`initialize_distributed` once before its first collective;
afterwards :func:`pyrayt_tpu_torch.parallel.default_mesh` lays the world's
ranks out as the ``('hosts', 'rays')`` mesh.

Trace jobs are short, so the failure policy is deliberately minimal, as in
the JAX package: a rank dropping out surfaces as a join timeout here or a
collective timeout in a step; recovery is re-running the job from the last
optimization checkpoint (``pyrayt_tpu_torch.analysis.checkpoint``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "is_distributed"]

# environment variables consulted (first hit wins): the JAX package's
# spellings; PyTorch's launchers (torchrun) add MASTER_ADDR / MASTER_PORT
# for the address and LOCAL_RANK / LOCAL_WORLD_SIZE for the device
_ADDR_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
_NPROC_VARS = ("JAX_NUM_PROCESSES", "NUM_PROCESSES", "WORLD_SIZE")
_PID_VARS = ("JAX_PROCESS_ID", "PROCESS_ID", "RANK")


def _env_int(names) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return None


def _env_str(names) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def _launcher_address() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def is_distributed() -> bool:
    """True when this process belongs to an initialised group of more than
    one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _pick_backend(backend: Optional[str], num_processes: int) -> str:
    """NCCL when every rank of this node owns a CUDA device, gloo without
    CUDA.  Ranks that share a card must name ``backend="gloo"``: NCCL
    refuses two ranks on one device, and the choice is never made
    silently."""
    if backend is not None:
        return backend
    if not torch.cuda.is_available():
        return "gloo"
    local_world = _env_int(("LOCAL_WORLD_SIZE",)) or num_processes
    n_cards = torch.cuda.device_count()
    if n_cards < local_world:
        raise ValueError(
            f"{local_world} ranks on this node share {n_cards} CUDA device(s); NCCL takes one "
            'device per rank: pass backend="gloo" for ranks that share a card'
        )
    return "nccl"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join (or skip) the multi-process group.  Idempotent.

    Resolution order per argument: the parameter, then the environment
    (``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``, else torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``; ``JAX_NUM_PROCESSES`` /
    ``NUM_PROCESSES`` / ``WORLD_SIZE``; ``JAX_PROCESS_ID`` / ``PROCESS_ID``
    / ``RANK``).  With no evidence of a multi-process launch the call is a
    no-op returning False, so single-process scripts can call it
    unconditionally.  The JAX package also reads a TPU pod's metadata
    (``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_COORDINATOR_ADDRESS``); a CUDA
    cluster has no such metadata, and its launchers set the variables
    above, so the port does not read them.

    ``coordinator_address`` is ``host:port`` (a TCP store that rank 0
    serves) or any ``torch.distributed`` init URL (``tcp://``,
    ``file://``, ``env://``).  ``initialization_timeout`` is in seconds.
    ``backend`` defaults to NCCL when each rank of the node owns a CUDA
    device (the rank's device is ``LOCAL_RANK``, else its rank) and to
    gloo on the CPU; ranks that share a card must pass ``"gloo"``.  A
    failed join raises: it never degrades to a single process.

    Returns True when running (or now joined) as part of a group of more
    than one rank.
    """
    if dist.is_initialized():
        return is_distributed()

    coordinator_address = (
        coordinator_address or _env_str(_ADDR_VARS) or _launcher_address()
    )
    num_processes = num_processes if num_processes is not None else _env_int(_NPROC_VARS)
    process_id = process_id if process_id is not None else _env_int(_PID_VARS)
    if coordinator_address is None and num_processes is None:
        return False  # single-process run: nothing to join
    if coordinator_address is None:
        raise ValueError(
            f"a launch of {num_processes} processes names no coordinator address "
            "(coordinator_address, JAX_COORDINATOR_ADDRESS or MASTER_ADDR/MASTER_PORT)"
        )
    if num_processes is None:
        raise ValueError(f"coordinator {coordinator_address!r} given without a process count")
    if process_id is None:
        if num_processes != 1:
            raise ValueError(f"a launch of {num_processes} processes names no process id")
        process_id = 0

    backend = _pick_backend(backend, num_processes)
    if backend == "nccl":
        local_rank = _env_int(("LOCAL_RANK",))
        torch.cuda.set_device(process_id if local_rank is None else local_rank)
    init_method = (
        coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    )
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id, **kwargs
    )
    return is_distributed()
