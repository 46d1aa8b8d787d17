"""Width sharding of the serving forward: the halo exchanges that the JAX
package gets from GSPMD (``tcct_tpu/parallel/mesh.py::data_sharding``
shards an NHWC tensor's width over a ``'model'`` mesh axis, and XLA inserts
each conv's halo exchange), written out.

Each rank of a ``'model'`` group holds a contiguous block of every B-scan's
columns at every level of the network: ``w`` columns of a level ``size * w``
wide, from column ``rank * w`` on (the widths split evenly at every level,
see ``infer/predictor.py``).  What couples columns needs the neighbours':

- a stride-1 conv with padding ``(ph, pw)`` takes ``pw`` halo columns from
  each side and runs with padding ``(ph, 0)``; a stride-2 3x3 conv (the
  MPViT stem, the stride-2 patch embeds) reads global columns 2j-1 .. 2j+1,
  so it takes a left halo only, and the shard's offset must be even
  (``models/layers.py::Conv2d.halo_columns``);
- the MetaPool site's window runs over the flat token order, in which a
  row's first token follows the row before's last: its halos wrap
  (:meth:`WidthShard.halos` with ``wrap=True``;
  ``ops/kernels/metapool.py::metapool_block_shard``);
- the decoder's 2x bilinear upsampling with ``align_corners=True`` takes its
  source coordinates from the global width
  (``ops/resize.py::upsample2x_aligned_shard``).

1x1 convs, eval BatchNorm, LayerNorm, the MLPs, 2x2 max-pooling (at even
offsets) and the argmax are local.

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
# stem, three pooling stages; the CNN branch's four pools): a width splits
# over M ranks when it is a multiple of WIDTH_QUANTUM * M
WIDTH_QUANTUM = 16

# mixers whose token pass is local but for the MetaPool window
SHARDED_MIXERS = ("metapool", "metapool_pallas")
# what a width shard does not serve yet, and the ROADMAP item that ports it
NOT_SHARDED = {
    "factor": "A.11.1 (attention over all tokens: an all-reduce over the 'model' group)",
    "hydra": "A.11.1 (attention over all tokens: an all-reduce over the 'model' group)",
    "metapool2d": "A.11.2 (the spatial pool's halo)",
    "relay": "A.11.3 (ReLayNet's pooling indices and unpooling)",
    "fused": "A.11.4 (K4, the fused CrossCNN block, on a six-conv halo)",
}


def _edges(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """What a rank sends: its first ``right`` and last ``left`` columns of
    NHWC ``x`` [B, H, w, C], in one [B, H, right + left, C] tensor."""
    return torch.cat([x[:, :, :right], x[:, :, x.shape[2] - left:]], dim=2).contiguous()


def _row_shift(t: torch.Tensor, down: bool) -> torch.Tensor:
    """``t`` [B, H, k, C] moved one row down (row h takes row h - 1) or up,
    zeros in the row it leaves."""
    z = torch.zeros_like(t[:, :1])
    return torch.cat([z, t[:, :-1]], 1) if down else torch.cat([t[:, 1:], z], 1)


def assemble_halos(edges: Sequence[torch.Tensor], rank: int, size: int, left: int, right: int,
                   wrap: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s halos from every rank's :func:`_edges`: ``left``
    columns of the rank before (its last) and ``right`` of the rank after
    (its first), NHWC [B, H, k, C].  At the global edges they are zeros;
    with ``wrap`` (the MetaPool window's flat token order) the first rank's
    left halo is the last rank's last columns one row up (row h takes row
    h - 1, row 0 zeros) and the last rank's right halo the first rank's
    first columns one row down."""
    lh = edges[(rank - 1) % size][:, :, right:]
    rh = edges[(rank + 1) % size][:, :, :right]
    if rank == 0:
        lh = _row_shift(lh, down=True) if wrap else torch.zeros_like(lh)
    if rank == size - 1:
        rh = _row_shift(rh, down=False) if wrap else torch.zeros_like(rh)
    return lh, rh


def check_halo(left: int, right: int, width: int) -> None:
    """A halo comes from the neighbouring rank only: no wider than its
    ``width`` columns."""
    if max(left, right) > width:
        raise ValueError(f"width shard: a halo of {max(left, right)} columns is wider than a "
                         f"rank's {width} at this level; use fewer 'model' ranks or a wider "
                         "input")


def cut_halos(whole: torch.Tensor, rank: int, size: int, left: int, right: int,
              wrap: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(shard, left halo, right halo)`` of rank ``rank`` cut from the whole
    NHWC tensor in one process: what an exchange gives that rank."""
    if whole.shape[2] % size:
        raise ValueError(f"width shard: {whole.shape[2]} columns do not split over {size} ranks")
    parts = torch.chunk(whole, size, 2)
    check_halo(left, right, parts[0].shape[2])
    edges = [_edges(p, left, right) for p in parts]
    return (parts[rank],) + assemble_halos(edges, rank, size, left, right, wrap)


def pad_columns(x: torch.Tensor, lh: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` with the NHWC halo columns ``lh`` and ``rh`` on its left
    and right, in channels_last memory."""
    return torch.cat([lh, x.permute(0, 2, 3, 1), rh], dim=2).permute(0, 3, 1, 2)


@dataclasses.dataclass
class WidthShard:
    """One rank's place in a ``'model'`` group: ``rank`` of ``size`` ranks,
    each holding a contiguous block of every level's columns, and the
    group's process ``group`` (None: the default group).  ``stats`` counts
    the exchanges and the bytes each rank sends."""

    rank: int
    size: int
    group: Optional[object] = None
    stats: Counter = dataclasses.field(default_factory=Counter)

    def level(self, w: int) -> Tuple[int, int]:
        """(offset, global width) of a level at which this rank holds ``w``
        columns."""
        return self.rank * w, self.size * w

    def require_even(self, w: int, what: str) -> None:
        """A stride-2 operation keeps its output grid on the global one only
        where the shard's offset is even."""
        if w % 2:
            raise ValueError(f"width shard: {what} at an odd offset ({w} columns a rank): the "
                             "input's width must be a multiple of "
                             f"{WIDTH_QUANTUM} x {self.size}")

    def halos(self, x: torch.Tensor, left: int, right: int,
              wrap: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The halos of NHWC ``x`` [B, H, w, C]: ``left`` columns from the
        rank before and ``right`` from the rank after (see
        :func:`assemble_halos`), by one all-gather of every rank's edge
        columns inside the group."""
        check_halo(left, right, x.shape[2])
        edges = _edges(x, left, right)
        self.stats["exchanges"] += 1
        self.stats["bytes"] += edges.numel() * edges.element_size()
        parts = D.all_gather_rows(edges[None], self.group).unbind(0)
        return assemble_halos(parts, self.rank, self.size, left, right, wrap)


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


def check_servable(model: nn.Module, cnn_impl: str = "plain") -> None:
    """Raise ``NotImplementedError`` for what a width shard does not serve:
    the attention and spatial-pool mixers, ReLayNet and the fused CNN
    branch, each naming the ROADMAP item that ports it."""
    base = getattr(model, "base", model)
    cfg = getattr(base, "vit_cfg", None)
    if cfg is None:
        what = "relay"
    elif cnn_impl == "fused":
        what = "fused"
    elif getattr(base, "flag_vit", True) and cfg.mixer not in SHARDED_MIXERS:
        what = cfg.mixer
    else:
        return
    raise NotImplementedError(f"width sharding does not serve {what!r} yet: ROADMAP "
                              f"{NOT_SHARDED[what]}")
