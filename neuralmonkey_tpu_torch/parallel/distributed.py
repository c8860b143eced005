"""Multi-process data parallelism over ``torch.distributed``
(counterpart of ``neuralmonkey_tpu/parallel/distributed.py``).

The JAX package runs one process per host over a global device mesh
and lets XLA derive the collectives from the shardings. The port runs
one process per device instead, the way PyTorch scales: every process
runs the same program on its own device, and the manager
(``runtime.CUDAManager``) calls the collectives of this module itself.

Launch contract (one command per process)::

    NM_COORDINATOR_ADDRESS=host0:8476 NM_NUM_PROCESSES=8 \
    NM_PROCESS_ID=<i> python -m neuralmonkey_tpu_torch.train exp.ini

or, under ``torchrun``, ``NM_DISTRIBUTED=auto`` (its ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``).
The entry points call :func:`maybe_initialize` before building
anything; without those variables it does nothing and the run is one
process. The backend is NCCL where CUDA is available, else gloo; rank
``i`` runs on ``cuda:<local rank>``.

As in the JAX package, every process reads the dataset and featurizes
the identical global batch; each takes its contiguous rows
(:func:`local_rows`), so the order, bucketing and shuffling of the data
are those of one process. A batch-level loss is a ratio of sums over
the global batch: inside :func:`sharded_batch` every such sum goes
through :func:`global_sum`, so every rank computes the global loss, and
the ranks' gradients summed are its gradient. Decoded rows come back to
every process through :func:`fetch_to_host`. Checkpoints are gathered
by every process and written by process 0 alone.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from datetime import timedelta
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..logging import log
from . import mesh

# whether the current pass runs on this rank's rows of a batch split
# over the ranks (set by the manager around a step or a fetch)
_SPLIT = contextvars.ContextVar("nm_batch_split", default=False)


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join this process to the process group.

    Reads ``NM_COORDINATOR_ADDRESS`` (``host:port``, or any
    ``init_method`` URL such as ``file:///shared/store``),
    ``NM_NUM_PROCESSES`` and ``NM_PROCESS_ID`` (explicit arguments
    win), or with ``NM_DISTRIBUTED=auto`` torchrun's variables. Without
    any of these it is a no-op. ``backend`` defaults to NCCL where CUDA
    is available and gloo elsewhere; gloo also runs on CUDA tensors,
    which lets two ranks share one card (NCCL refuses that).

    Returns True when this process is in a process group."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "NM_COORDINATOR_ADDRESS")
    auto = os.environ.get("NM_DISTRIBUTED", "").lower() in (
        "auto", "1", "true")
    if coordinator_address is None and not auto:
        return False
    if coordinator_address is not None:
        num_processes = (num_processes if num_processes is not None
                         else int(os.environ["NM_NUM_PROCESSES"]))
        process_id = (process_id if process_id is not None
                      else int(os.environ["NM_PROCESS_ID"]))
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    else:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device_index(process_id))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(minutes=10))
    log(f"torch.distributed initialized: process {process_id}/"
        f"{num_processes}, backend {backend}")
    return True


def local_device_index(process_id: Optional[int] = None) -> int:
    """The CUDA device of this process: torchrun's ``LOCAL_RANK``, else
    its rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if process_id is None else process_id
    return rank % max(torch.cuda.device_count(), 1)


def is_initialized() -> bool:
    return dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def data_count() -> int:
    """The ranks a batch splits over: the mesh's ``data`` axis (the
    world when no model axis is set)."""
    return mesh.size("data")


def data_index() -> int:
    """This rank's place on the ``data`` axis."""
    return mesh.index("data")


def is_main_process() -> bool:
    """True on the process that owns the host's side effects
    (checkpoints, the ``.best`` link, metrics and output files)."""
    return process_index() == 0


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def _comm_device() -> torch.device:
    """Where a collective's own buffers live: the card under NCCL."""
    if _nccl():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_processes(name: str = "nm_sync") -> None:
    """A barrier across all processes (a no-op in one process); around
    checkpoint writes, so that no process reads a file process 0 has
    not finished."""
    del name
    if process_count() == 1:
        return
    if _nccl():
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_flags(flags: Sequence[bool]) -> tuple:
    """Process 0's boolean decisions on every process: wall-clock
    periods differ between processes, and validation reaches
    collectives, so all must take the same branch. One int tensor
    broadcast; in one process the flags unchanged."""
    if process_count() == 1:
        return tuple(bool(f) for f in flags)
    values = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                          device=_comm_device())
    dist.broadcast(values, 0)
    return tuple(bool(v) for v in values.tolist())


def on_every_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on every data rank: one int all-reduced to
    its minimum over the data group; in one rank ``flag`` itself."""
    if data_count() == 1:
        return bool(flag)
    value = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=_comm_device())
    dist.all_reduce(value, op=dist.ReduceOp.MIN, group=mesh.group("data"))
    return bool(value.item())


def split_rows(batch_size: int) -> bool:
    """Whether a batch of ``batch_size`` rows splits over the data ranks
    (there are several and they divide it); otherwise every rank holds
    all of it, as the JAX package replicates a batch its mesh does not
    divide. The ranks of one model or context group hold the same
    rows."""
    return (dist.is_initialized() and data_count() > 1
            and batch_size % data_count() == 0)


def local_rows(value: np.ndarray) -> np.ndarray:
    """This rank's contiguous rows of a global host batch
    (``make_global_array``'s data-sharded placement)."""
    rows = value.shape[0] // data_count()
    start = data_index() * rows
    return value[start:start + rows]


@contextlib.contextmanager
def sharded_batch(split: bool) -> Iterator[None]:
    """Within the block, :func:`global_sum` reduces over the ranks when
    ``split`` (each rank holds its rows of the batch), and
    :func:`param_term` divides its gradient among them."""
    token = _SPLIT.set(bool(split) and dist.is_initialized())
    try:
        yield
    finally:
        _SPLIT.reset(token)


def batch_is_split() -> bool:
    """Whether the current pass runs on this rank's rows of a batch
    split over the data ranks (inside :func:`sharded_batch`)."""
    return _SPLIT.get() and data_count() > 1


class _GlobalSum(torch.autograd.Function):
    """All-reduce sum forward; the gradient passes through unchanged.
    Every rank computes the same function of the global sums, so each
    rank's gradient is its own rows' share of the global gradient, and
    the ranks' gradients summed are the global gradient."""

    @staticmethod
    def forward(ctx, x):  # pylint: disable=arguments-differ
        del ctx
        total = x.detach().clone()
        dist.all_reduce(total, group=mesh.group("data"))
        return total

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        del ctx
        return grad


def global_sum(x: torch.Tensor, split: Optional[bool] = None
               ) -> torch.Tensor:
    """``x`` summed over the ranks' rows of a split batch (inside
    :func:`sharded_batch`), differentiably; ``x`` itself otherwise.
    ``split=True`` sums whatever the batch (a sum over the ranks' parts
    of a divided parameter, ``parallel/fsdp.py``)."""
    if split is None:
        split = _SPLIT.get()
    if not split or data_count() == 1:
        return x
    return _GlobalSum.apply(x)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the rows of the global batch."""
    count = x.new_tensor(float(x.numel()))
    return global_sum(x.sum()) / global_sum(count)


class _ParamTerm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share):  # pylint: disable=arguments-differ
        ctx.share = share
        return x.clone()

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return grad * ctx.share, None


def param_term(x: torch.Tensor) -> torch.Tensor:
    """A loss term of the parameters alone (the l1 and l2 terms), which
    every rank computes whole: its value unchanged, its gradient divided
    by the ranks on a split batch, so that it enters their summed
    gradient once."""
    if not _SPLIT.get() or data_count() == 1:
        return x
    return _ParamTerm.apply(x, 1.0 / data_count())


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the data ranks in place."""
    if data_count() > 1:
        dist.all_reduce(tensor, group=mesh.group("data"))
    return tensor


def all_gather_flat(local: torch.Tensor) -> torch.Tensor:
    """Every data rank's flat ``local`` (all of one size), concatenated
    in rank order."""
    if data_count() == 1:
        return local.reshape(-1).clone()
    out = local.new_empty(local.numel() * data_count())
    dist.all_gather_into_tensor(out, local.detach().contiguous(),
                                group=mesh.group("data"))
    return out


def reduce_scatter_flat(full: torch.Tensor) -> torch.Tensor:
    """This rank's segment of ``full`` (data-rank-major, equal segments)
    summed over the data ranks."""
    if data_count() == 1:
        return full.reshape(-1).clone()
    out = full.new_empty(full.numel() // data_count())
    dist.reduce_scatter_tensor(out, full.detach().contiguous(),
                               group=mesh.group("data"))
    return out


def _host(value: torch.Tensor) -> np.ndarray:
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.numpy()


def _gather_rows(value: torch.Tensor, dim: int) -> torch.Tensor:
    """Every data rank's ``value`` concatenated along ``dim``; the ranks'
    other dims padded with zeros to the largest first (decodes that
    stopped at different lengths)."""
    device = value.device
    shape = torch.tensor(value.shape, dtype=torch.int64, device=device)
    shapes = all_gather_flat(shape).view(data_count(), -1).tolist()
    largest = [max(s[i] for s in shapes) for i in range(value.dim())]
    pads = []
    for i in reversed(range(value.dim())):
        pads.extend((0, largest[i] - value.shape[i]))
    wide = value.to(torch.uint8) if value.dtype == torch.bool else value
    padded = torch.nn.functional.pad(wide, pads)
    gathered = all_gather_flat(padded.reshape(-1)).view(
        data_count(), *largest)
    parts = [gathered[r].narrow(dim, 0, shapes[r][dim])
             for r in range(data_count())]
    out = torch.cat(parts, dim=dim)
    return out.bool() if value.dtype == torch.bool else out


def fetch_to_host(tree: Dict[str, Any],
                  batch_dims: Optional[Dict[str, int]] = None
                  ) -> Dict[str, np.ndarray]:
    """A runner's fetches of a split batch as host arrays, on every
    process: a tensor with a batch axis (axis 0, or ``batch_dims[key]``)
    is gathered from the ranks in rank order; a scalar (a loss, already
    global) is taken as it is."""
    batch_dims = batch_dims or {}
    out = {}
    for key, value in tree.items():
        if isinstance(value, torch.Tensor) and value.dim() > 0:
            value = _gather_rows(value, batch_dims.get(key, 0))
        out[key] = (_host(value) if isinstance(value, torch.Tensor)
                    else np.asarray(value))
    return out
