"""The device mesh (JAX counterpart ``tcct_tpu/parallel/mesh.py``).

A ``('data',)`` mesh over the ranks of the initialised process group, one
device a rank: batches split on their leading axis, each rank holding a
contiguous block of rows (JAX's ``P('data')``), parameters and state
replicated.  Where the JAX package lets XLA make BatchNorm's statistics
global and add the gradients, the port's train step does both itself
(``train/step.py``): the batch statistics through the two-phase train
BatchNorm and an all-reduce of its [2, C] sums, the gradients through one
all-reduce of their flat concatenation.

A ``('data', 'model')`` mesh of shape (D, M) also splits each B-scan's
width over the M ranks of a ``'model'`` group, as the JAX package's
``data_sharding`` does for NHWC tensors (the long-input serving layout).
Ranks are laid out data-major, as JAX's ``devs.reshape(shape)``: rank
``d * M + m`` holds rows block ``d`` and columns block ``m``.  The halo
exchanges that GSPMD inserts are ``parallel/spatial.py``'s; the width
shard serves (``infer/predictor.py``) and does not train.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from tcct_tpu_torch.parallel import distributed as D


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks of one mesh: ``size`` ranks, this process's ``rank`` among
    them, their process ``group`` (None: the default group, or no group at
    all for a one-rank mesh without one) and this rank's ``device``.
    ``shape`` maps axis names to sizes, as a JAX mesh's.  With a ``'model'``
    axis of ``model_size`` > 1, ``model_group`` is the process group of this
    rank's data row (its ``model_size`` ranks ``d * M .. d * M + M - 1``)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    size: int
    rank: int
    group: Optional[object]
    device: torch.device
    backend: str
    model_size: int = 1
    model_group: Optional[object] = None

    @property
    def data_size(self) -> int:
        """Ranks along ``'data'``: the blocks a batch's rows split into."""
        return self.size // self.model_size

    @property
    def data_rank(self) -> int:
        """This rank's ``'data'`` coordinate: its block of a batch's rows."""
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        """This rank's ``'model'`` coordinate: its block of the columns."""
        return self.rank % self.model_size

    def rows(self, batch: int) -> D.Rows:
        """This rank's rows of a global batch of ``batch`` rows."""
        return D.row_range(batch, self.data_size, self.data_rank)

    def shards(self, batch: int) -> bool:
        """Whether a batch of ``batch`` rows splits over the mesh; a batch
        that does not runs replicated, every rank on all of it."""
        return batch % self.data_size == 0

    def width_shard(self, width: int):
        """This rank's ``parallel.spatial.WidthShard`` for inputs ``width``
        columns wide (None without a ``'model'`` axis above 1).  Raises for
        a width that does not split (``parallel.spatial.width_blocks``)."""
        if self.model_size == 1:
            return None
        from tcct_tpu_torch.parallel.spatial import WidthShard, width_blocks

        return WidthShard(self.model_rank, width_blocks(width, self.model_size),
                          self.model_group)

    def all_gather_blocks(self, t: torch.Tensor, width: int) -> torch.Tensor:
        """Every rank's block ``t`` [b, H, w, ...] of a batch ``width``
        columns wide (its rows and its columns, as :func:`shard_batch` cuts
        them) gathered into the whole [D * b, H, width, ...] on every rank;
        at ``'model'`` 1, :meth:`all_gather_rows`.  A narrower block travels
        padded to the widest and is cropped."""
        if self.model_size == 1:
            return self.all_gather_rows(t)
        from tcct_tpu_torch.parallel.spatial import width_blocks

        M = self.model_size
        widths = width_blocks(width, M)
        pad = max(widths) - t.shape[2]
        if pad:
            t = torch.cat([t, t.new_zeros(t.shape[:2] + (pad,) + t.shape[3:])], dim=2)
        parts = self.all_gather_rows(t[None])  # [D * M, b, H, max(widths), ...] in rank order
        rows = [torch.cat([parts[d * M + m][:, :, :widths[m]] for m in range(M)], dim=2)
                for d in range(self.data_size)]
        return torch.cat(rows)

    def require_data_only(self, what: str) -> None:
        """Raise for a ``'model'`` axis above 1 where ``what`` splits rows
        only (the train step: a width shard serves and does not train)."""
        if self.model_size > 1:
            raise NotImplementedError(
                f"{what}: a 'model' axis of {self.model_size} shards the width for serving "
                "only (infer/predictor.py); train on a ('data',) mesh")

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh in place (a one-rank group still runs
        the collective; without a group it is ``t``)."""
        return D.all_reduce_(t, self.group) if self.backend != "none" else t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return D.gather_rows(t, self.group) if self.size > 1 else t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return D.all_gather_rows(t, self.group) if self.size > 1 else t

    def barrier(self, name: str = "", timeout_s: int = D.DEFAULT_TIMEOUT_S) -> None:
        if self.size > 1:
            D.barrier(name, timeout_s, self.group)

    @property
    def is_writer(self) -> bool:
        """Rank 0 of the mesh: the one that writes checkpoints and logs."""
        return self.rank == 0


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> DataMesh:
    """A mesh over the first ``n_devices`` ranks of the process group (all
    of them by default; one device a rank).  ``shape`` partitions them over
    the named axes; the default puts every rank on the first.  A
    ``('data', 'model')`` mesh of shape (D, M) lays its ranks out
    data-major (rank ``d * M + m``, JAX's ``devs.reshape(shape)``) and
    gives each data row a ``'model'`` group: every rank creates every group,
    in the same order.  Without an initialised group only a one-rank mesh
    exists (this process).  A rank past ``n_devices`` gets a mesh of which
    it is no member (``rank`` -1).  Its device is the rank's
    (``distributed.rank_device``)."""
    world = dist.get_world_size() if D.is_initialized() else 1
    n = n_devices or world
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name axes {tuple(axis_names)}")
    sizes = dict(zip(axis_names, shape))
    if "data" not in sizes:
        raise ValueError(f"make_mesh: axes {tuple(axis_names)} have no 'data' axis")
    if world < n:
        raise RuntimeError(
            f"make_mesh: need {n} devices, only {world} visible (one device a rank). "
            "Start one process a device (TCCT_NUM_PROCESSES / TCCT_PROCESS_ID, or torchrun) "
            "and call parallel.init_distributed() first")
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if set(sizes) - {"data", "model"}:
        raise ValueError(f"make_mesh: axes {tuple(axis_names)}: only 'data' and 'model' exist")
    device = D.rank_device()
    if not D.is_initialized():
        return DataMesh(tuple(axis_names), sizes, 1, 0, None, device, "none")
    me = dist.get_rank()
    group = None
    if n < world:  # every rank of the default group takes part in new_group
        group = dist.new_group(ranks=list(range(n)))
    m_size, m_group = sizes.get("model", 1), None
    if m_size > 1:
        for d in range(n // m_size):  # one group a data row, created by every rank
            g = dist.new_group(ranks=list(range(d * m_size, (d + 1) * m_size)))
            if me // m_size == d:
                m_group = g
    return DataMesh(tuple(axis_names), sizes, n, me if me < n else -1, group, device,
                    dist.get_backend(), m_size, m_group)


def pick_dp_devices(bs: int, n_devices: int) -> int:
    """Largest device count <= n_devices that divides the global batch, so
    DP keeps single-device batch semantics exactly (CLI --pl)."""
    return max(d for d in range(1, max(n_devices, 1) + 1) if bs % d == 0)


def shard_batch(mesh: Optional[DataMesh], batch):
    """This rank's contiguous block of leading rows of each tensor (or
    array) of ``batch`` (one, or a tuple or list of them), as JAX's
    ``P('data')`` lays them out; on a ``'model'`` axis above 1 a 4-D
    (NHWC) one also its block of the width (axis 2), as JAX's
    ``data_sharding``, in whole 16-column units
    (``parallel.spatial.width_blocks``: where W / 16 is not a multiple of M
    the first ranks hold one unit more, where JAX splits W / M evenly).  A
    batch whose rows do not split over the mesh, or no mesh, comes back
    whole."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    if mesh is None or not mesh.shards(batch.shape[0]):
        return batch
    rows = mesh.rows(batch.shape[0])
    batch = batch[rows.start:rows.stop]
    if mesh.model_size > 1 and batch.ndim == 4:
        from tcct_tpu_torch.parallel.spatial import width_blocks

        blocks = width_blocks(batch.shape[2], mesh.model_size)
        start = sum(blocks[:mesh.model_rank])
        batch = batch[:, :, start:start + blocks[mesh.model_rank]]
    return batch


@torch.no_grad()
def replicate(mesh: Optional[DataMesh], module_or_tensors):
    """Rank 0's values in every rank's copy, in place: every parameter and
    buffer of a module, or a tensor, or each tensor of a list or tuple.
    Returns its argument."""
    if mesh is None or mesh.size == 1:
        return module_or_tensors
    if isinstance(module_or_tensors, nn.Module):
        tensors = list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
    elif isinstance(module_or_tensors, torch.Tensor):
        tensors = [module_or_tensors]
    else:
        tensors = list(module_or_tensors)
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    for t in tensors:
        D.broadcast_(t.data if isinstance(t, nn.Parameter) else t, src=src, group=mesh.group)
    return module_or_tensors
