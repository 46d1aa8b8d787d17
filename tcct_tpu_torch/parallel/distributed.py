"""Process groups and the collectives of data parallelism (JAX counterpart
``tcct_tpu/parallel/distributed.py``).

The JAX package runs one program over a device mesh and lets XLA insert the
collectives (GSPMD).  Here each rank is a process with one device, and the
port's code calls the collectives itself, through ``torch.distributed``:

- :func:`init_distributed` brings up the default process group from
  arguments, the JAX package's ``TCCT_COORDINATOR`` / ``TCCT_NUM_PROCESSES``
  / ``TCCT_PROCESS_ID``, or torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``RANK`` / ``WORLD_SIZE``.  It picks NCCL when every rank of the host has
  a CUDA device of its own and gloo otherwise (the CPU, or ranks sharing a
  card: NCCL refuses two ranks on one device).
- :func:`all_reduce_` (a sum or a max), :func:`all_gather_rows` and
  :func:`broadcast_` are the only collectives the port uses (gloo has no
  ``reduce_scatter``).  Under gloo a CUDA tensor goes through the host: its copy on the CPU is
  reduced, gathered or broadcast and copied back.
- :func:`gather_rows` is the differentiable gather of a row-sharded
  tensor: the forward concatenates every rank's rows, the backward hands
  each rank the gradient of its own rows times the rank count (only the
  local slice carries autograd).  A loss computed identically on every
  rank from the gathered tensors then gives every parameter, on every
  rank, ``ranks`` times its share of the whole gradient (the share of this
  rank's rows below the gather, the whole gradient above it), and one
  average over the ranks is the one-process gradient.
- :func:`row_range` is this rank's contiguous block of a global batch
  (a :class:`Rows`), the layout of JAX's ``P('data')``.

Every collective names its group; ``None`` is the default group.
"""

from __future__ import annotations

import datetime
import os
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300
_RANK_DEVICE: Optional[torch.device] = None  # set by init_distributed


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def launched_processes() -> int:
    """The number of processes the launcher started (``TCCT_NUM_PROCESSES``
    or torchrun's ``WORLD_SIZE``), 1 when neither is set."""
    return _env_int("TCCT_NUM_PROCESSES", "WORLD_SIZE") or 1


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout_s: int = DEFAULT_TIMEOUT_S) -> torch.device:
    """Initialise the default process group and return this rank's device.

    ``coordinator_address`` is ``host:port`` (or an init URL such as
    ``file:///path``); with none of the three given, ``TCCT_COORDINATOR`` /
    ``TCCT_NUM_PROCESSES`` / ``TCCT_PROCESS_ID`` are read, then torchrun's
    ``RANK`` / ``WORLD_SIZE`` with ``MASTER_ADDR`` / ``MASTER_PORT``.
    ``device`` is a card unless the caller names the CPU: ``None`` or
    ``cuda`` is ``cuda:<local rank % cards>`` (the local rank is
    ``LOCAL_RANK`` or the process id), and with no card visible it raises.
    ``backend`` defaults to ``nccl`` when the device is a card and the
    host's ranks (``LOCAL_WORLD_SIZE``, else every process) are no more
    than its cards, else ``gloo``; asking for ``nccl`` with ranks sharing a
    card raises.  ``timeout_s`` bounds the group's collectives."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("TCCT_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("TCCT_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("TCCT_PROCESS_ID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: give num_processes and process_id, or set "
                         "TCCT_NUM_PROCESSES / TCCT_PROCESS_ID (or torchrun's WORLD_SIZE / RANK)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not cards:
        raise RuntimeError(f"init_distributed: {device} was asked for and no card is visible; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % cards)
    own_card = device.type == "cuda" and local_world <= cards
    if backend is None:
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl" and not own_card:
        raise ValueError(f"init_distributed: nccl needs a card for each rank; {local_world} "
                         f"ranks of this host share {cards} card(s) on {device} (use gloo)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    global _RANK_DEVICE
    _RANK_DEVICE = device
    print(f"DISTRIBUTED: rank {process_id}/{num_processes} backend={backend} device={device}",
          flush=True)
    return device


def rank_device() -> torch.device:
    """This rank's device: the one :func:`init_distributed` chose, else the
    current card where one is visible, else the CPU."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_multiprocess_mesh(mesh) -> bool:
    """True if the mesh spans more than one process (each rank is one)."""
    return mesh is not None and mesh.size > 1


def barrier(name: str = "", timeout_s: int = DEFAULT_TIMEOUT_S, group=None) -> None:
    """Wait until every rank of ``group`` is here, at most ``timeout_s``
    seconds (then raise, naming ``name``).  Nothing without a process
    group."""
    if not is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    try:
        if dist.get_backend(group) == "gloo":
            dist.monitored_barrier(group=group, timeout=timeout)
        else:
            dist.barrier(group=group, async_op=True).wait(timeout=timeout)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def _staged(t: torch.Tensor, group) -> bool:
    """True where the collective runs on a host copy: gloo and a CUDA tensor."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Sum (``op='sum'``) or maximise (``'max'``) ``t`` over the ranks of
    ``group``, in place; returns ``t``."""
    how = _REDUCE_OPS[op]
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=how, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=how, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` of rank ``src`` (a rank of the default group) into every
    rank's ``t``, in place; returns ``t``."""
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on ``t``'s device.  Not differentiable (:func:`gather_rows` is)."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, start, stop):
        ctx.rows, ctx.ranks = (start, stop), dist.get_world_size(group)
        return all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.rows
        return g[start:stop] * ctx.ranks, None, None, None


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The whole batch of a row-sharded ``t`` (every rank's rows alike),
    differentiable: the gradient of the result flows back into this rank's
    own rows only, times the rank count (no collective in the backward), so
    that the gradients of every rank, averaged, are the one-process
    gradient (exactly, for a power-of-two rank count)."""
    rank, b = dist.get_rank(group), t.shape[0]
    return _GatherRows.apply(t, group, rank * b, (rank + 1) * b)


class Rows(NamedTuple):
    """A rank's contiguous rows ``[start, stop)`` of a global batch of
    ``total`` rows."""

    start: int
    stop: int
    total: int


def row_range(batch: int, size: int, rank: int) -> Rows:
    """Rank ``rank``'s contiguous rows of a batch of ``batch`` rows over
    ``size`` ranks (``batch % size == 0``), the layout of JAX's
    ``P('data')``."""
    if batch % size:
        raise ValueError(f"a batch of {batch} does not split over {size} ranks")
    n = batch // size
    return Rows(rank * n, (rank + 1) * n, batch)
