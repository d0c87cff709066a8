"""Multi-process runtime on ``torch.distributed``
(``digipathai_tpu/parallel/distributed.py``).

A slide sweep is embarrassingly parallel: each process segments
``slides[process_index::process_count]`` (``shard_slides``).  The training
step's data-parallel axis (``training/train.make_dp_train_step``) runs
over the process group this module starts.

Bootstrap (any one of):
  * env: ``DPAI_COORDINATOR=host:port DPAI_NUM_PROCESSES=N DPAI_PROCESS_ID=i``
  * arguments to :func:`initialize`

Without a coordinator the run is single-process and every call here is the
identity.  The process group uses nccl for ``device="cuda"`` (each process
on card ``process_id % device_count``) and gloo for the CPU.  The JAX
package's TPU pod-metadata bootstrap has no counterpart.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: how long a barrier or collective waits: hosts in a sweep can be minutes
#: apart
TIMEOUT = timedelta(hours=1)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> None:
    """Start the default process group (idempotent).

    Arguments default to ``DPAI_COORDINATOR`` (``host:port``),
    ``DPAI_NUM_PROCESSES`` and ``DPAI_PROCESS_ID``.  With no coordinator it
    is a no-op."""
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("DPAI_COORDINATOR")
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("DPAI_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DPAI_PROCESS_ID", "0"))
    if torch.device(device).type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_slides(slides: Sequence[str]) -> List[str]:
    """This process's share of a slide sweep (deterministic round-robin)."""
    return list(slides)[process_index()::process_count()]


def barrier() -> None:
    """Block until every process reaches the barrier; no-op single-process.
    On gloo it is ``monitored_barrier``, which names a rank that does not
    arrive within ``TIMEOUT``; on nccl ``barrier`` (the group's timeout,
    also ``TIMEOUT``)."""
    if process_count() == 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=TIMEOUT)
    else:
        dist.barrier()


def all_hosts_total(value: float) -> float:
    """Sum a process-local scalar over all processes (slide counts,
    seconds) with one all-reduce; the identity single-process."""
    if process_count() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device="cuda" if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t)
    return float(t.item())


def shutdown() -> None:
    """Destroy the process group (a no-op single-process): a process that
    exits with its gloo group alive can abort in the group's threads."""
    if dist.is_initialized():
        dist.destroy_process_group()
