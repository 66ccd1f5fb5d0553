"""Process groups for data parallelism over ``torch.distributed``.

Counterpart of ``rdpn6d_tpu/parallel/mesh.py``. The JAX package runs one
program over a mesh of every device, and XLA inserts the cross-device
reductions where the math reduces over the batch. Here each card (or CPU
process) is one rank of a process group: NCCL between cards, gloo on the
CPU. The train step reduces the BatchNorm statistics, the loss
normalisers and the gradients itself (``all_reduce_sum``), so that N ranks
take the step one process takes on the global batch.

``shard_batch`` has no counterpart: each rank loads its own share of the
global batch (``data/loader.train_group_iterator`` with this rank's shard),
as the JAX package's multi-host path does, so no batch crosses ranks.

A process that never calls ``init_distributed`` is in no group; every
function here then acts as on a single rank and runs no collective.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist


def in_group() -> bool:
    """Whether this process belongs to a process group (even of one)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def world() -> int:
    return dist.get_world_size() if in_group() else 1


def is_main() -> bool:
    return rank() == 0


def init_distributed(rank: int, world: int, init_method: str,
                     device: str | torch.device,
                     backend: str | None = None) -> torch.device:
    """Join the group of ``world`` processes as ``rank`` through
    ``init_method`` (``tcp://host:port`` or ``file://path``) and return
    this rank's device: ``cuda:<rank>`` for ``device="cuda"``, the named
    card for ``cuda:<i>``, else ``device``. The backend is NCCL for CUDA
    and gloo for the CPU unless ``backend`` names one. The card is made
    current before the group exists: NCCL's communicator, ``barrier`` and
    ``all_gather_object`` use the current device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device {str(dev)!r} but CUDA "
                               "is not available")
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kwargs)
    return dev


def close_group() -> None:
    if in_group():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is a SUM all-reduce of the incoming
    gradient: with S = sum over ranks of x_r and each rank's loss L_r a
    function of S, d(sum_r L_r)/d(x_q) = sum_r dL_r/dS on every rank q."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable; ``x`` itself when
    this process is in no group."""
    if not in_group():
        return x
    return _AllReduceSum.apply(x)


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, so that
    every rank starts from rank 0's weights (after init, load or resume).
    Counterpart of ``replicate``; nothing to do in no group."""
    if in_group():
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def gather_predictions(local: list[Any]) -> list[Any]:
    """Every rank's list, concatenated in rank order, on every rank
    (``all_gather_object``: pickled, as the JAX package's gather is).
    Counterpart of ``gather_predictions``."""
    if not in_group():
        return local
    out: list[Any] = [None] * world()
    dist.all_gather_object(out, local)
    return [x for part in out for x in part]


def barrier() -> None:
    if in_group():
        dist.barrier()


def _spawned(local: int, fn: Callable, world: int, init_method: str,
             device: str, backend: str | None, out_dir: str,
             args: tuple) -> None:
    dev = init_distributed(local, world, init_method, device, backend)
    try:
        result = fn(dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{local}.pt"))
    finally:
        close_group()


def spawn(fn: Callable, world: int, args: tuple = (),
          device: str = "cuda", backend: str | None = None) -> list[Any]:
    """Run ``fn(device, *args)`` in ``world`` new processes (``spawn``
    start method) that form one group through a file store, each on its
    device as ``init_distributed`` picks it; returns each rank's result in rank
    order (``torch.save``-able). If a rank raises, the others are stopped
    and the error is raised here."""
    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="rdpn6d_dist_")
    try:
        init = "file://" + os.path.join(work, "store")
        mp.start_processes(_spawned, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, init, str(device), backend,
                                 work, args))
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
