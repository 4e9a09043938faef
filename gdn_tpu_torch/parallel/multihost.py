"""Process-group start-up (port of ``gdn_tpu/parallel/multihost.py``).

The JAX package runs one controller over every chip; ``jax.distributed``
joins hosts.  The port runs one process a rank, joined by
``torch.distributed``:

- ``maybe_initialize`` starts the process group when a coordinator is
  given (an argument, or torchrun's ``MASTER_ADDR``/``RANK``/
  ``WORLD_SIZE``), and refuses a topology without one.
- ``choose_backend`` is the backend rule: ``nccl`` when each rank has a
  card of its own, ``gloo`` on the CPU and when ranks share a card.
  The choice is printed, and a failure of the backend is raised: no
  other backend is tried.
- ``rank_device`` is a rank's card, ``cuda:{local_rank % device_count}``.
- ``local_batch_slice`` is this rank's rows of the global batch.
- ``run_ranks`` starts N ranks of a function with the ``spawn`` start
  method (a parent that has touched CUDA cannot fork) over a ``file://``
  rendezvous in a fresh temporary directory (no port to collide on).

Each rank reads the same global batch order (same seed, same cursor) and
keeps its own rows; a loader that can decode only those rows may.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(global_rank: Optional[int] = None) -> int:
    """This process's rank on its host: torchrun's ``LOCAL_RANK``, else
    the global rank (the ranks ``run_ranks`` starts share one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() if global_rank is None else global_rank


def rank_device(device_type: str = "cuda", global_rank: Optional[int] = None
                ) -> torch.device:
    """The device of this rank (of ``global_rank`` before the group
    exists): ``cuda:{local_rank % device_count}``, or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", local_rank(global_rank) % max(1, torch.cuda.device_count()))


def choose_backend(device_type: str, world: int, local_world: Optional[int] = None
                   ) -> Tuple[str, str]:
    """(backend, why): nccl when every rank on a host has a card of its
    own, gloo on the CPU or when ranks share a card (NCCL refuses two
    ranks on one device; gloo carries CUDA tensors through the host)."""
    if device_type != "cuda":
        return "gloo", "ranks on the CPU"
    local_world = world if local_world is None else local_world
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s) a host, {cards} card(s): one card each"
    return "gloo", f"{local_world} ranks a host share {cards} card(s)"


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: str = "cuda") -> bool:
    """Start the process group when a coordinator is given: the
    argument (``host:port``, ``tcp://...`` or ``file://...``) or
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  Returns whether more than one rank runs.

    Safe to call unconditionally: with no configuration it starts
    nothing.  ``num_processes``/``process_id`` without a coordinator
    raise, as in the JAX package: the ranks would otherwise train alone
    on the full batch each."""
    if dist.is_initialized():
        return world_size() > 1
    env = os.environ
    address = coordinator_address
    if address is None and env.get("MASTER_ADDR"):
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if address:
        world = num_processes if num_processes is not None else int(env["WORLD_SIZE"])
        me = process_id if process_id is not None else int(env["RANK"])
        backend, why = choose_backend(device_type, world,
                                      int(env.get("LOCAL_WORLD_SIZE", world)))
        print(f"[parallel] rank {me} of {world}: backend {backend} ({why})", flush=True)
        if device_type == "cuda":
            torch.cuda.set_device(rank_device("cuda", me))
        dist.init_process_group(backend, init_method=_init_method(address),
                                world_size=world, rank=me)
        return world > 1
    if num_processes is not None or process_id is not None:
        raise ValueError("num_processes/process_id given but no coordinator_address "
                         "(or torchrun's MASTER_ADDR) to initialize against")
    return False


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, end) of this rank's rows in the global batch."""
    n = world_size()
    assert global_batch % n == 0, (
        f"global batch {global_batch} must divide across {n} processes")
    per = global_batch // n
    i = rank()
    return i * per, (i + 1) * per


def _rank_main(r: int, fn: Callable, world: int, address: str, device_type: str,
               args: tuple) -> None:
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    maybe_initialize(address, world, r, device_type=device_type)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: tuple = (), device_type: str = "cuda",
              timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``world`` spawned ranks of one process group;
    raises when a rank fails, and kills them all and raises
    TimeoutError after ``timeout`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="gdn_ranks_") as d:
        address = f"file://{os.path.join(d, 'rendezvous')}"
        ctx = mp.start_processes(_rank_main, args=(fn, world, address, device_type, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
