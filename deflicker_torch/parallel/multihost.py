"""Multi-host fan-out at video granularity (the JAX package's
`parallel/multihost.py` on `torch.distributed`).

Each video touches only its own tensors, so hosts share no collective:

  * every host runs the SAME `cli.batch --dcn` command;
  * `init_distributed` joins the hosts into one gloo group over TCP, a
    handshake by which they agree on who is who; nothing else crosses the
    hosts' network;
  * `assign_videos` deals each host a disjoint round-robin share of the
    video list;
  * within a host, `local_mesh` groups the ranks that share it (one a
    card, under `torchrun --nproc_per_node`), so the within-video
    parallelism (parallel/mesh.py) stays on the host.

A "process" is a host, as in JAX: `--num_processes` counts hosts and
`--process_id` is a host's index.  One line per host:

    python -m deflicker_torch.cli.batch --dcn --coordinator host0:29500 \
        --num_processes 4 --process_id <k> --video_dir data/videos

or, with every card of each host, `torchrun --nnodes 4 --node_rank <k>
--nproc_per_node <cards> --master_addr host0 --master_port 29500 -m
deflicker_torch.cli.batch --dcn --video_dir data/videos`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh, _backend


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _local_world() -> int:
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else one."""
    return _env_int("LOCAL_WORLD_SIZE") or 1


def _hosts() -> Tuple[int, int]:
    """(host index, host count) in the initialised default group, whose
    ranks are numbered host by host."""
    local = _local_world()
    return dist.get_rank() // local, dist.get_world_size() // local


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the hosts (idempotent).  Returns (host index, host count).

    Under `torchrun` (LOCAL_WORLD_SIZE in the environment) every rank
    joins the default group through torchrun's own store (`env://`), and
    the hosts come from the ranks: host = rank // LOCAL_WORLD_SIZE, as
    torchrun numbers ranks host by host; arguments, where given, must
    agree with them.  Otherwise each value resolves as in the JAX
    package: the argument, then the environment (JAX_COORDINATOR_ADDRESS
    / JAX_NUM_PROCESSES / JAX_PROCESS_ID, then torch's
    MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK, one process a host), and
    the hosts meet in a gloo group over TCP at `coordinator`.  With
    nothing configured no group is made and (0, 1) comes back."""
    if not dist.is_initialized() and os.environ.get("LOCAL_WORLD_SIZE") \
            and (_env_int("WORLD_SIZE") or 1) > 1:
        dist.init_process_group("gloo", init_method="env://")
        host, hosts = _hosts()
        if num_processes not in (None, hosts) \
                or process_id not in (None, host):
            raise ValueError(f"torchrun's ranks make host {host} of "
                             f"{hosts}, the arguments say {process_id} "
                             f"of {num_processes}")
        return host, hosts
    if dist.is_initialized():
        return _hosts()
    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if (num_processes or 1) <= 1:
        return 0, 1
    if coordinator is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         f"address and a process id (got {coordinator!r}, "
                         f"{process_id!r})")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return process_id, num_processes


def assign_videos(videos: Sequence, process_id: int,
                  num_processes: int) -> List:
    """This process's disjoint share of the video list.

    Round-robin (videos[k::n]) rather than contiguous blocks: batch lists
    are commonly sorted (by name ~ by scene/length), and dealing
    interleaves long and short videos evenly across hosts.
    """
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    return list(videos)[process_id::num_processes]


def local_mesh(axis_name: str = DATA_AXIS) -> Optional[Mesh]:
    """A mesh over the ranks that share this host (None when this host
    runs one).  Ranks are numbered host by host, as torchrun numbers them;
    the video axis is already split across hosts by `assign_videos`, so no
    collective of the mesh leaves the host."""
    local = _local_world()
    if not dist.is_initialized() or local <= 1:
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    cuda = torch.cuda.is_available()
    mine = None
    for host in range(world // local):
        # every rank makes every group, in the same order
        group = dist.new_group(list(range(host * local, (host + 1) * local)),
                               backend=_backend("cuda" if cuda else "cpu",
                                                local))
        if rank // local == host:
            mine = group
    device = (torch.device("cuda", (rank % local) % torch.cuda.device_count())
              if cuda else torch.device("cpu"))
    if cuda:
        torch.cuda.set_device(device)
    return Mesh(mine, rank % local, local, device, axis_name)
