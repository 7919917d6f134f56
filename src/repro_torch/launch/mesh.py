"""Meshes over ``torch.distributed``, and the process group under them.

Ported from ``repro/launch/mesh.py``: ``make_production_mesh``,
``make_mesh`` and ``best_effort_mesh`` build ``DeviceMesh``es with named
dims (``init_device_mesh``). JAX is single-controller and sees every
device from one process; here every device is one rank of a process
group, so the port adds what the reference does not need:

* :func:`init_distributed` brings the process group up: ``nccl`` for
  ``cuda``, ``gloo`` only for an explicit ``cpu``. It joins the group that
  ``torchrun`` describes in the environment, or starts one of its own on
  ``localhost``; every group has a timeout, so a rank that never arrives
  fails the collective instead of hanging. A CUDA request on a machine
  without a card raises: it never falls back to the CPU.
* :func:`run_ranks` spawns a function on N ranks of one group (``gloo``
  on the CPU: the tests, ``launch/serve.py --device cpu --shards N``;
  ``nccl``, one card a rank) and joins them within a deadline.

Nothing here runs when the module is imported.
"""
from __future__ import annotations

import datetime
import math
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.runtime.device import resolve_device

GROUP_TIMEOUT_S = 60.0  # a collective waits at most this long for a rank


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", *, world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Bring up (or join) the default process group for ``device`` and
    return this rank's device (``cuda:<local rank>`` on the card).

    Under ``torchrun`` (``WORLD_SIZE``/``RANK`` in the environment) the
    group is the one it describes; otherwise ``world_size`` (default 1)
    ranks meet at ``init_method`` (default: a free port on localhost).
    An already initialized group is kept as it is.
    """
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        if "LOCAL_RANK" in os.environ:      # torchrun: one card a rank
            local = int(os.environ["LOCAL_RANK"])
        elif (world_size or 1) > 1:         # spawned ranks: card = rank
            local = int(rank or 0)
        else:
            local = dev.index
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank needs cuda:{local} but the host has "
                f"{torch.cuda.device_count()} card(s)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group is up; {dev} needs "
                f"{backend}")
        return dev
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if "WORLD_SIZE" in os.environ and world_size is None:
        dist.init_process_group(backend, timeout=timeout,
                                **({"device_id": dev}
                                   if dev.type == "cuda" else {}))
        return dev
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://127.0.0.1:{free_port()}",
        world_size=world_size or 1, rank=rank or 0, timeout=timeout,
        **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


def _device_type() -> str:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "repro_torch.launch.mesh.init_distributed first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """An arbitrary named mesh over the process group's ranks (its size
    must equal the product of ``shape``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if dist.is_initialized() and math.prod(shape) != dist.get_world_size():
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks; "
            f"the process group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def best_effort_mesh(model_parallel: int = 1):
    """Elastic helper: the largest (data, model) mesh the ranks of the
    process group support; ``model_parallel`` is fixed by the checkpoint
    layout, the data axis absorbs whatever is left."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by TP={model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"))


# ---------------------------------------------------------------------------
# N ranks in N processes
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world_size: int, port: int, device: str,
               fn: Callable, args: tuple, results, quiet: bool) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # N ranks share the host's cores
    if quiet and rank:
        devnull = open(os.devnull, "w")
        os.dup2(devnull.fileno(), 1)
    try:
        init_distributed(device, world_size=world_size, rank=rank,
                         init_method=f"tcp://127.0.0.1:{port}")
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:  # the parent reports it and stops the others
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args: Any,
              device: str = "cpu", timeout_s: float = 300.0,
              quiet: bool = False) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks of one group (CPU
    ranks over ``gloo``, or over ``nccl`` with rank ``r`` on ``cuda:r``),
    each in its own spawned process with one torch thread, and return the
    values by rank. ``fn`` and its arguments and results must
    pickle (a module-level function).

    Raises with the rank's traceback if one fails, and after
    ``timeout_s``; the other ranks are then stopped, so a deadlock fails
    the caller instead of hanging it. ``quiet`` silences the standard
    output of every rank but 0.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, device, fn, args,
                               results, quiet), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    error = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = (f"{world_size} ranks: no result from ranks "
                         f"{sorted(set(range(world_size)) - set(out))} "
                         f"within {timeout_s:.0f} s")
                break
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    error = (f"rank(s) {dead} died with exit code(s) "
                             f"{[procs[r].exitcode for r in dead]}")
                continue
            if ok:
                out[rank] = val
            else:
                error = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if error is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [out[r] for r in range(world_size)]
