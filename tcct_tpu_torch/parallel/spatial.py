"""Width sharding of the serving forward: the halo exchanges that the JAX
package gets from GSPMD (``tcct_tpu/parallel/mesh.py::data_sharding``
shards an NHWC tensor's width over a ``'model'`` mesh axis, and XLA inserts
each conv's halo exchange), written out.

Each rank of a ``'model'`` group holds a contiguous block of every B-scan's
columns at every level of the network: the input's columns split in whole
16-column units (:func:`width_blocks`; 96 over 4 ranks: 32, 32, 16, 16), so
that a rank holding ``b`` input columns holds ``b / s`` of a level ``1/s`` of
the input's width, from the sum of the ranks before it on
(:meth:`WidthShard.level`).  What couples columns needs the neighbours':

- a stride-1 conv with padding ``(ph, pw)`` takes ``pw`` halo columns from
  each side and runs with padding ``(ph, 0)``; a stride-2 3x3 conv (the
  MPViT stem, the stride-2 patch embeds) reads global columns 2j-1 .. 2j+1,
  so it takes a left halo only, and the shard's offset must be even
  (``models/layers.py::Conv2d.halo_columns``);
- the MetaPool site's window runs over the flat token order, in which a
  row's first token follows the row before's last: its halos wrap
  (:meth:`WidthShard.halos` with ``wrap=True``;
  ``ops/kernels/metapool.py::metapool_block_shard``); the ``metapool2d``
  mixer's spatial window takes one column a side without the wrap
  (``ops/pool.py::metapool_spatial_shard``);
- the fused CrossCNN block (K4) runs on its input widened by ``k // 2 + 2``
  columns a side, its receptive radius, and is cropped; on a side that is
  the image's edge it takes no halo (``clip=True``), so that the kernel's
  own zero padding of each conv's input stands at the edge
  (``models/crosscnn.py::cross_resnet_fused``);
- the decoder's 2x bilinear upsampling with ``align_corners=True`` takes its
  source coordinates from the global width
  (``ops/resize.py::upsample2x_aligned_shard``);
- factorized and hydra attention reduce over all tokens: their partial sums
  (and factor's softmax max and sum) are all-reduced in the group
  (:meth:`WidthShard.all_reduce_`, ``models/mpvit.py``).

A halo may be wider than a neighbour's block (``msca``'s 1x21 strip conv
needs 10 columns where duke's deepest level has 9 a rank at M = 4): it is
cut from as many ranks as it reaches.  1x1 convs, eval BatchNorm,
LayerNorm, the MLPs, 2x2 max-pooling and ReLayNet's pooling with masks and
unpooling (at even offsets) and the argmax are local.

:class:`WidthShard` is one rank's place; :func:`width_shard` makes the
modules of a model see it for the length of a forward, in the idiom of
``models/layers.py::train_pass``.  An exchange is one ``all_gather`` of
every rank's edge columns inside the ``'model'`` group (over gloo, a CUDA
tensor goes through the host), from which each rank cuts its halos
(:func:`assemble_halos`); an operation widens its block with them
(:func:`pad_columns`) or takes them as tensors (the site).  :func:`cut_halos`
cuts the same halos from a whole tensor in one process, which is how the
tests hold each operation's halo math to the whole-tensor operation.  The
maps are gathered over both mesh axes by ``DataMesh.all_gather_blocks``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tcct_tpu_torch.parallel import distributed as D

# the deepest level of an FTC model is 1/16 of the input's width (the MPViT
# stem, three pooling stages; the CNN branch's four pools): the input's
# columns split over the ranks in whole units of WIDTH_QUANTUM columns
WIDTH_QUANTUM = 16


def width_blocks(width: int, size: int) -> Tuple[int, ...]:
    """Each rank's columns of an input ``width`` columns wide over ``size``
    ``'model'`` ranks: the ``width / 16`` whole 16-column units split as
    evenly as possible, the first ``(width / 16) mod size`` ranks one unit
    more (672 over 4: 176, 176, 160, 160).  Every level's offsets then stay
    whole and even before each 2x2 pool and stride-2 conv.

    Raises where ``width`` is not a multiple of ``size`` (JAX's rule: its
    ``NamedSharding`` wants a sharded dimension divisible by the mesh
    axis), where it is not a multiple of 16 (the deepest level is 1/16),
    and where a rank would hold no columns."""
    if width % size:
        raise ValueError(f"width shard: a width of {width} does not split over {size} 'model' "
                         "ranks: as in JAX, whose NamedSharding wants a sharded dimension "
                         "divisible by the size of its mesh axis")
    if width % WIDTH_QUANTUM:
        raise ValueError(f"width shard: a width of {width} is not a multiple of "
                         f"{WIDTH_QUANTUM} (the deepest level is 1/{WIDTH_QUANTUM})")
    units = width // WIDTH_QUANTUM
    if units < size:
        raise ValueError(f"width shard: a width of {width} has {units} {WIDTH_QUANTUM}-column "
                         f"units for {size} 'model' ranks: a rank would hold no columns")
    base, extra = divmod(units, size)
    return tuple(WIDTH_QUANTUM * (base + (r < extra)) for r in range(size))


def _edges(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """What a rank sends: its first ``right`` and last ``left`` columns of
    NHWC ``x`` [B, H, w, C], in one [B, H, right + left, C] tensor.  A rank
    narrower than a halo sends all its columns, the first ones at the start
    of their slot and the last ones at its end, zeros between: every rank
    sends one shape."""
    w = x.shape[2]
    r, l = min(w, right), min(w, left)
    parts = [x[:, :, :r], x.new_zeros(x.shape[:2] + (right - r + left - l,) + x.shape[3:]),
             x[:, :, w - l:]]
    return torch.cat(parts, dim=2).contiguous()


def _row_shift(t: torch.Tensor, down: bool) -> torch.Tensor:
    """``t`` [B, H, k, C] moved one row down (row h takes row h - 1) or up,
    zeros in the row it leaves."""
    z = torch.zeros_like(t[:, :1])
    return torch.cat([z, t[:, :-1]], 1) if down else torch.cat([t[:, 1:], z], 1)


def assemble_halos(edges: Sequence[torch.Tensor], rank: int, widths: Sequence[int], left: int,
                   right: int, wrap: bool = False,
                   clip: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s halos from every rank's :func:`_edges`: the ``left``
    columns before its block and the ``right`` after it, NHWC [B, H, k, C],
    cut from as many ranks on each side as they take (``widths``: every
    rank's columns at this level).  Past the global edges they are zeros,
    or with ``clip`` absent (a halo then stops at the image's edge).  With
    ``wrap`` (the MetaPool window's flat token order; one column a side)
    the first rank's left halo is the last rank's last column one row up
    (row h takes row h - 1, row 0 zeros) and the last rank's right halo the
    first rank's first column one row down."""
    size, e = len(widths), edges[rank]

    def zeros(n):
        return e.new_zeros(e.shape[:2] + (n,) + e.shape[3:])

    lpieces, need, j = [], left, rank - 1
    while need and j >= 0:
        k = min(need, widths[j])
        lpieces.insert(0, edges[j][:, :, right + left - k:])
        need, j = need - k, j - 1
    if need and not clip:
        lpieces.insert(0, zeros(need))
    rpieces, need, j = [], right, rank + 1
    while need and j < size:
        k = min(need, widths[j])
        rpieces.append(edges[j][:, :, :k])
        need, j = need - k, j + 1
    if need and not clip:
        rpieces.append(zeros(need))
    lh = torch.cat(lpieces, 2) if lpieces else zeros(0)
    rh = torch.cat(rpieces, 2) if rpieces else zeros(0)
    if wrap:
        if (left, right) != (1, 1):
            raise ValueError(f"width shard: a wrapped halo is one column a side, not "
                             f"({left}, {right})")
        if rank == 0:
            lh = _row_shift(edges[size - 1][:, :, right:], down=True)
        if rank == size - 1:
            rh = _row_shift(edges[0][:, :, :right], down=False)
    return lh, rh


def cut_halos(whole: torch.Tensor, rank: int, widths: Sequence[int], left: int, right: int,
              wrap: bool = False,
              clip: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(shard, left halo, right halo)`` of rank ``rank`` cut from the whole
    NHWC tensor in one process: what an exchange gives that rank.  The
    ranks hold ``widths`` columns each."""
    if sum(widths) != whole.shape[2]:
        raise ValueError(f"width shard: blocks {tuple(widths)} are not "
                         f"{whole.shape[2]} columns")
    parts = torch.split(whole, list(widths), 2)
    edges = [_edges(p, left, right) for p in parts]
    return (parts[rank],) + assemble_halos(edges, rank, widths, left, right, wrap, clip)


def pad_columns(x: torch.Tensor, lh: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` with the NHWC halo columns ``lh`` and ``rh`` on its left
    and right, in channels_last memory."""
    return torch.cat([lh, x.permute(0, 2, 3, 1), rh], dim=2).permute(0, 3, 1, 2)


@dataclasses.dataclass
class WidthShard:
    """One rank's place in a ``'model'`` group: rank ``rank`` of the ranks
    whose columns at the input are ``blocks`` (:func:`width_blocks`), each
    holding a contiguous block of every level's columns, and the group's
    process ``group`` (None: the default group).  ``stats`` counts the halo
    exchanges and the bytes each rank sends in them (``exchanges``,
    ``bytes``), and the all-reduces of the attention mixers with theirs
    (``reduces``, ``reduce_bytes``)."""

    rank: int
    blocks: Tuple[int, ...]
    group: Optional[object] = None
    stats: Counter = dataclasses.field(default_factory=Counter)

    @property
    def size(self) -> int:
        return len(self.blocks)

    def widths(self, w: int) -> Tuple[int, ...]:
        """Every rank's columns at the level at which this rank holds
        ``w``."""
        scale, rem = divmod(self.blocks[self.rank], w)
        if rem or scale & (scale - 1) or any(b % scale for b in self.blocks):
            raise ValueError(f"width shard: {w} columns are no level of the blocks "
                             f"{self.blocks} (rank {self.rank})")
        return tuple(b // scale for b in self.blocks)

    def level(self, w: int) -> Tuple[int, int]:
        """(offset, global width) of a level at which this rank holds ``w``
        columns."""
        ws = self.widths(w)
        return sum(ws[:self.rank]), sum(ws)

    def require_even(self, w: int, what: str) -> None:
        """A stride-2 operation keeps its output grid on the global one only
        where the shard's offset and width are even."""
        off = self.level(w)[0]
        if off % 2 or w % 2:
            raise ValueError(f"width shard: {what} at an odd offset or width ({w} columns from "
                             f"column {off}): the input's columns must split in whole "
                             f"{WIDTH_QUANTUM}-column units (parallel/spatial.py::width_blocks)")

    def halos(self, x: torch.Tensor, left: int, right: int, wrap: bool = False,
              clip: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The halos of NHWC ``x`` [B, H, w, C]: ``left`` columns from the
        ranks before and ``right`` from the ranks after, as many ranks as
        they reach (see :func:`assemble_halos`), by one all-gather of every
        rank's edge columns inside the group."""
        widths = self.widths(x.shape[2])
        edges = _edges(x, left, right)
        self.stats["exchanges"] += 1
        self.stats["bytes"] += edges.numel() * edges.element_size()
        parts = D.all_gather_rows(edges[None], self.group).unbind(0)
        return assemble_halos(parts, self.rank, widths, left, right, wrap, clip)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op='sum'``) or maximised (``'max'``) over the
        group, in place: the attention mixers' reductions over all tokens."""
        self.stats["reduces"] += 1
        self.stats["reduce_bytes"] += t.numel() * t.element_size()
        return D.all_reduce_(t, self.group, op)


@contextlib.contextmanager
def width_shard(model: nn.Module, shard: Optional[WidthShard]):
    """Inside the block, every module of ``model`` whose class declares a
    ``width_shard`` attribute sees ``shard``: its forward then takes the
    rank's block of the columns and exchanges the halos it needs.  With
    ``shard`` None the block runs as it would without it."""
    if shard is None:
        yield
        return
    mods = [m for m in model.modules() if hasattr(type(m), "width_shard")]
    for m in mods:
        m.width_shard = shard
    try:
        yield
    finally:
        for m in mods:
            m.width_shard = None

