"""The data-parallel mesh on `torch.distributed`: one rank per card.

The JAX package's `parallel/mesh.py` puts every data-parallel axis of the
workload on one 1-D device mesh and lets XLA insert the collectives.  Here a
`Mesh` is a process group with this process's place in it, and the
parallel paths call the collectives themselves:

  * atlas fit: every rank draws the full sample batch from the same seeded
    generator and keeps its block; the loss divides local sums by the
    global counts, the gradients go through ONE all-reduce a step
    (atlas/engine.run_fit_schedule);
  * rendering: frames split over the ranks, then gathered
    (atlas/render.render_frames);
  * RAFT flow: the pair batch splits, then gathers (flow/engine.RAFTFlow);
  * stage-2 UNet: the frame batch splits, then gathers; the refinement stays
    sequential per video, the multi-video refinement splits the video axis
    (filter/engine.py);
  * multi-video fit: the video axis splits, no collective in the fit
    (atlas/multifit.py).

A split is a contiguous block per rank whose size may be uneven (the first
`n % size` ranks take one more).  A gather pads every block to the largest
one, all-gathers them and drops the padding; every collective stages its
tensors where the backend takes them (the host under gloo, the rank's card
under NCCL).  With `mesh` None, or of size 1, the split and gather helpers
return their input unchanged.

Ranks start in one of three ways: `launch` spawns n ranks on free local
ports (`--mesh_devices N`); `torchrun` sets the environment that
`make_mesh` reads; or the caller initialises the default group itself.
Only rank 0 writes files; every rank runs the same calls in the same order.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]

# the all-gather into one tensor (newer torch renames it)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a group of ranks, one card (or the CPU)
    each.  `group` None means a mesh of one with no process group."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis_name: str = DATA_AXIS

    @property
    def shape(self) -> dict:
        """{axis_name: size}, as `jax.sharding.Mesh.shape` reads."""
        return {self.axis_name: self.size}

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def is_main(mesh: Optional[Mesh]) -> bool:
    """True on the rank that writes files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def _sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def _span(n: int, size: int, rank: int) -> tuple:
    q, r = divmod(n, size)
    start = rank * q + min(rank, r)
    return start, start + q + (rank < r)


def block(n: int, mesh: Optional[Mesh]) -> tuple:
    """(start, stop) of this rank's contiguous block of n items."""
    if not _sharded(mesh):
        return 0, n
    return _span(n, mesh.size, mesh.rank)


def data_axis_sharding(x: torch.Tensor, mesh: Optional[Mesh],
                       axis: int = 0) -> torch.Tensor:
    """This rank's block of `x` along `axis` (a view)."""
    start, stop = block(x.shape[axis], mesh)
    return x.narrow(axis, start, stop - start)


def batch_sharding(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's block of a leading (batch) axis."""
    return data_axis_sharding(x, mesh, 0)


def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x where the backend takes it: a host copy of a CUDA tensor under
    gloo (which takes CUDA tensors only for some collectives), a copy on
    the rank's card of a host tensor under NCCL; else x itself."""
    if mesh.backend == "gloo" and x.is_cuda:
        return x.cpu()
    if mesh.backend == "nccl" and not x.is_cuda:
        return x.to(mesh.device)
    return x


def _run(op: Callable, x: torch.Tensor, mesh: Mesh) -> None:
    """Run the collective `op(tensor, group=...)` on x in place."""
    y = _staged(x, mesh)
    op(y, group=mesh.group)
    if y is not x:
        x.copy_(y)


@torch.no_grad()
def _flat(op: Callable, xs: Tensors, mesh: Mesh,
          buf: Optional[torch.Tensor] = None) -> Tensors:
    """`op` on one tensor, or on a list of tensors of one dtype and device
    as ONE flat buffer (one collective), written back in place.  `buf`: a
    buffer of their total size to hold them (a captured step's, made
    outside its capture); None, a new one."""
    if isinstance(xs, torch.Tensor):
        _run(op, xs, mesh)
        return xs
    buf = torch.cat([x.reshape(-1) for x in xs], out=buf)
    _run(op, buf, mesh)
    for x, part in zip(xs, buf.split([x.numel() for x in xs])):
        x.copy_(part.view_as(x))
    return xs


@torch.no_grad()
def shard_constraint(x: torch.Tensor, mesh: Optional[Mesh], axis: int = 0,
                     n: Optional[int] = None) -> torch.Tensor:
    """The full tensor from every rank's block along `axis`, on x's device
    (one all-gather of the blocks padded to the largest; `n` is the full
    length, all-reduced from the blocks when not given).  The JAX function
    annotates a layout and leaves the value whole; here the whole value is
    assembled from the blocks."""
    if not _sharded(mesh):
        return x
    if n is None:
        count = torch.tensor([x.shape[axis]])
        _run(dist.all_reduce, count, mesh)
        n = int(count.item())
    start, stop = block(n, mesh)
    if x.shape[axis] != stop - start:
        raise ValueError(f"rank {mesh.rank} holds {x.shape[axis]} of {n} "
                         f"items along axis {axis}, its block is "
                         f"{stop - start}")
    m = -(-n // mesh.size)
    mine = _staged(x.movedim(axis, 0), mesh)
    padded = mine.new_zeros((m, *mine.shape[1:]))
    padded[:stop - start] = mine
    parts = padded.new_empty((mesh.size * m, *mine.shape[1:]))
    _all_gather(parts, padded, group=mesh.group)
    full = torch.cat([parts[k * m:k * m + b - a] for k, (a, b) in enumerate(
        _span(n, mesh.size, k) for k in range(mesh.size))])
    return full.to(x.device).movedim(0, axis)


def replicated(xs: Tensors, mesh: Optional[Mesh]) -> Tensors:
    """Rank 0's values on every rank (a broadcast in place, one for a list
    of tensors of one dtype)."""
    if not _sharded(mesh):
        return xs
    return _flat(lambda t, group: dist.broadcast(
        t, dist.get_global_rank(group, 0), group=group), xs, mesh)


def all_reduce_sum(xs: Tensors, mesh: Optional[Mesh],
                   buf: Optional[torch.Tensor] = None) -> Tensors:
    """The sum over the ranks, in place (one all-reduce for a list of
    tensors of one dtype, staged in `buf` when given).  Runs whenever the
    mesh has a process group, also at size 1, where it leaves the values as
    they are."""
    if mesh is None or mesh.group is None:
        return xs
    return _flat(dist.all_reduce, xs, mesh, buf)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank gets here (files rank 0 wrote are then on
    disk for the others)."""
    if _sharded(mesh):
        one = torch.zeros(1, device=mesh.device)
        _run(dist.all_reduce, one, mesh)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's picklable `obj` on every rank."""
    if not _sharded(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, dist.get_global_rank(mesh.group, 0),
                               group=mesh.group, device=mesh.device
                               if mesh.backend == "nccl" else None)
    return box[0]


def _backend(device_type: str, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (NCCL refuses
    two ranks on one card)."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS) -> Optional[Mesh]:
    """A mesh over the initialised default group (the world, or its first
    `n_devices` ranks; ranks past them get None), each rank on LOCAL_RANK's
    card (or the CPU).  Under `torchrun` (WORLD_SIZE and MASTER_ADDR in the
    environment) the default group is initialised here first: NCCL on
    CUDA, gloo when ranks outnumber cards or there is no card.  With no
    group, a mesh of one."""
    cuda = torch.cuda.is_available()
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(
            _backend("cuda" if cuda else "cpu", int(os.environ["WORLD_SIZE"])),
            init_method="env://")
    if not dist.is_initialized():
        return Mesh(None, 0, 1, torch.device("cuda", 0) if cuda
                    else torch.device("cpu"), axis_name)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"{n} ranks asked of a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                           % torch.cuda.device_count()) if cuda
              else torch.device("cpu"))
    return Mesh(group, rank, n, device, axis_name)


def free_port() -> int:
    """A TCP port free on this host now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, n: int, device_type: str, port: int,
               queue, timeout_s: float, args: tuple) -> None:
    device = torch.device("cpu")
    if device_type == "cuda":
        # ranks share the cards round-robin when they outnumber them
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        _backend(device_type, n), init_method=f"tcp://127.0.0.1:{port}",
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(Mesh(dist.group.WORLD, rank, n, device), *args)
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device="cuda", args: tuple = (),
           timeout: Optional[float] = None) -> List:
    """Run `fn(mesh, *args)` on n ranks started with
    `torch.multiprocessing.spawn` on a free local port, one card a rank
    (NCCL; ranks share the cards under gloo when there are more ranks than
    cards; gloo on the CPU).  `fn` must be importable (a module-level
    function) and return something picklable without tensors.  Returns
    each rank's result in rank order.  A rank that raises fails the call
    (the others are ended); past `timeout` seconds every rank is ended and
    TimeoutError raised, and a collective that waits longer than it raises
    in its rank."""
    import torch.multiprocessing as tmp

    device_type = torch.device(device).type
    ctx = tmp.get_context("spawn")
    queue = ctx.SimpleQueue()
    wait_s = 1800.0 if timeout is None else float(timeout)
    procs = tmp.start_processes(
        _rank_main, args=(fn, n, device_type, free_port(), queue, wait_s,
                          tuple(args)),
        nprocs=n, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    results = {}

    def drain():
        while not queue.empty():
            rank, out = queue.get()
            results[rank] = out

    try:
        while not procs.join(timeout=0.5):
            drain()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    drain()
    return [results[r] for r in range(n)]


def run_on_mesh(fn: Callable, n: Optional[int], device, args: tuple = ()):
    """The entry points' `--mesh_devices`: with n > 1 ranks (None: every
    visible card) `launch` runs `fn(mesh, *args)` on each and rank 0's result
    is returned; inside an initialised group of several ranks (`torchrun`)
    `fn` runs here on `make_mesh()`; otherwise `fn(None, *args)` runs here."""
    device = torch.device(device)
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) > 1:
        mesh = make_mesh(n)
        return None if mesh is None else fn(
            mesh if mesh.size > 1 else None, *args)
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        return launch(fn, n, device, args)[0]
    return fn(None, *args)
