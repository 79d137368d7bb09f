"""Multi-host process bootstrap, the counterpart of
`kagnn_tpu/dist/init.py::initialize_multihost`: `init_process_group` from
the caller's arguments or the JAX module's environment names
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID). Every process calls it
once before it builds a step; afterwards the default group spans all
processes and dist/mesh.py builds its subgroups.

Nothing in a host tells a process of its cluster: the address (host:port
of rank 0, `tcp://` implied), the number of processes and each one's id
come from the caller. The backend too: "nccl" (one card a process, the
card LOCAL_RANK or, by default, the process id) or "gloo"; a process whose
card does not exist raises rather than sharing another's.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "nccl") -> None:
    """Initialise the default process group from the arguments, else the
    environment. A no-op when the group already exists, or when no process
    count is given either way (a single process needs no group)."""
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    n = num_processes if num_processes is not None else (
        int(os.environ["NUM_PROCESSES"]) if "NUM_PROCESSES" in os.environ else None)
    pid = process_id if process_id is not None else (
        int(os.environ["PROCESS_ID"]) if "PROCESS_ID" in os.environ else None)
    if n is None:
        return
    if addr is None or pid is None:
        raise ValueError("initialize_multihost needs the coordinator's address "
                         "and this process's id with the process count "
                         "(arguments or COORDINATOR_ADDRESS / PROCESS_ID)")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", pid))
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= count:
            raise RuntimeError(
                f"nccl takes one card a process: process {pid} wants card "
                f"{local} and this host has {count}; use backend='gloo' to "
                f"share one card")
        torch.cuda.set_device(local)
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=addr, world_size=int(n),
                            rank=int(pid))
