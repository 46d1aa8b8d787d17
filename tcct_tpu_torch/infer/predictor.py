"""Bucketed volume predictor (JAX counterpart
``tcct_tpu/infer/predictor.py``).

Each dataset geometry is one static bucket (``data/geometry.py``): whole
OCT volumes stream through it in fixed-size batches, the tail batch
padded with zeros.  uint8 B-scans go to the device and are normalised
there in the serving dtype (bf16 by default); a uint8 class map (argmax
of the main head) comes back.

``cnn_impl`` chooses the CNN branch of an FTC model: ``'plain'``, the
module path (cuDNN convs), or ``'fused'``, one launch of the fused block
kernel per CrossCNN block (``ops/kernels/crosscnn_fused.py``).  The JAX
predictor's ``'packed'`` is the TPU's lane layout and has no counterpart.

``mesh`` (a ``parallel.DataMesh``) serves data-parallel: every rank is
given the whole volume, runs its rows of each bucket-sized batch (the
batch size a multiple of the mesh's ``'data'`` ranks) and gathers the uint8
class maps of the others, so every rank returns the whole volume's maps.
On a ``('data', 'model')`` mesh of shape (D, M), M > 1, a rank also runs
only its block of each scan's width and the same share of every level
(``parallel/spatial.py``: the halo exchanges and the attention mixers'
all-reduces inside its ``'model'`` group), and the maps are gathered over
both axes.  The columns split in whole 16-column units, the first ranks
one unit more where W / 16 is not a multiple of M
(``parallel/spatial.py::width_blocks``); W must be a multiple of M, as in
JAX, and hold at least M units.  A width shard serves every model of the
registry, with every mixer and both CNN branches.

On a CUDA card without a mesh, each bucket (a batch's shape) is served from
CUDA graphs after its first batch (``infer/graphs.py``): the first batch
runs the forward eagerly and captures it, split at the ``tcct::`` calls and
the ``model.*`` spans, and every later batch copies its uint8 input into the
tape's static input and replays it, bit for bit the eager maps.  A mesh
predictor (collectives and halo exchanges inside the forward) and the CPU
serve every batch eagerly.  ``stats`` counts the captures, each bucket's
tape and the batches replayed and served eagerly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tcct_tpu_torch.data.eyeset import postprocess
from tcct_tpu_torch.data.geometry import DatasetGeometry, get_geometry
from tcct_tpu_torch.infer import graphs
from tcct_tpu_torch.models.crosscnn import cross_resnet_fused
from tcct_tpu_torch.parallel.mesh import shard_batch
from tcct_tpu_torch.parallel.spatial import width_shard
from tcct_tpu_torch.utils.tracing import span


class VolumePredictor:
    """Static-shape bucketed predictor for one dataset geometry.

    ``model`` is moved to ``device`` and cast to ``dtype`` (parameters and
    BN statistics alike, as the JAX predictor's ``cast_floating`` does).
    ``mesh``: see the module's docstring; ``shard`` is then this rank's
    ``parallel.spatial.WidthShard`` (None without a ``'model'`` axis above
    1), whose ``stats`` count the halo exchanges and the all-reduces.

    ``stats``: ``captures`` (tapes captured), ``tapes`` (for each bucket,
    the batch's shape, its tape's ``segments``, ``tcct_calls`` and
    ``spans``: the spans a replay opens, by name), and the batches
    ``replayed`` from a tape and served ``eager``."""

    def __init__(self, model: torch.nn.Module, geo: DatasetGeometry, batch_size: int = 8,
                 dtype: torch.dtype = torch.bfloat16, device="cuda", cnn_impl: str = "plain",
                 mesh=None):
        if cnn_impl == "packed":
            raise ValueError("cnn_impl='packed' is the JAX package's space-to-depth layout for "
                             "the TPU's lane width; this package has 'plain' and 'fused'")
        if cnn_impl not in ("plain", "fused"):
            raise ValueError(f"unknown cnn_impl {cnn_impl!r}; have 'plain' and 'fused'")
        base = getattr(model, "base", model)
        if cnn_impl == "fused" and not hasattr(getattr(base, "base_cnn", None), "path_estan"):
            raise ValueError(f"cnn_impl='fused': {type(base).__name__} has no CrossCNN blocks "
                             "to fuse")
        if mesh is not None:
            if mesh.rank < 0:
                raise ValueError("VolumePredictor: this rank is not a member of the mesh")
            if batch_size % mesh.data_size:
                raise ValueError(f"VolumePredictor: batch size {batch_size} does not split "
                                 f"over the mesh's {mesh.data_size} 'data' ranks")
            device = mesh.device
        self.mesh = mesh
        self.shard = mesh.width_shard(geo.prep_hw[1]) if mesh is not None else None
        self.cnn_impl = cnn_impl
        self.device = torch.device(device)
        if self.device.type == "cuda" and dtype == torch.float32:
            # f32 means f32: cuDNN's default TF32 convs drift by ~1e-3
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.to(device=self.device, dtype=dtype,
                              memory_format=torch.channels_last).eval()
        self.geo = geo
        self.batch_size = batch_size
        self.dtype = dtype
        self._tapes = {}  # bucket (the batch's shape) -> its graphs.Tape
        self.stats = {"captures": 0, "tapes": {}, "replayed": 0, "eager": 0}

    @torch.inference_mode()
    def logits(self, x_u8: torch.Tensor) -> torch.Tensor:
        """The main head's NHWC logits of a uint8 batch on the device (on a
        width shard, of the rank's block of the columns)."""
        x = x_u8.to(self.dtype) / 255.0
        with width_shard(self.model, self.shard):
            if self.cnn_impl == "fused":
                base = getattr(self.model, "base", self.model)
                with span("model.cnn"):
                    feats = cross_resnet_fused(x, base.base_cnn)
                return self.model(x, cnn_feats=feats)[0]
            return self.model(x)[0]

    @torch.inference_mode()
    def _forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        """The eager forward: the uint8 maps of a uint8 batch on the device."""
        return torch.argmax(self.logits(x_u8), dim=-1).to(torch.uint8)

    def _eager(self, x_u8: torch.Tensor) -> torch.Tensor:
        """A batch of a bucket that has no tape: on a card without a mesh,
        the bucket's first, which also captures its tape."""
        self.stats["eager"] += 1
        if self.mesh is not None or self.device.type != "cuda":
            return self._forward(x_u8)
        maps, tape = graphs.capture(self._forward, x_u8)
        self._tapes[tuple(x_u8.shape)] = tape
        self.stats["tapes"][tuple(x_u8.shape)] = {"segments": tape.segments,
                                                  "tcct_calls": tape.tcct_calls,
                                                  "spans": tape.spans}
        self.stats["captures"] += 1
        return maps

    def predict_scans(self, imgs_u8: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] uint8 (already geometry-prepped) -> [N, H, W] uint8
        class maps.  N is arbitrary; the last batch is padded to the bucket
        size.  Every batch is queued on the device, its maps copied into the
        volume's, before the one copy of the results back to the host.  On a
        mesh each rank runs its block of each batch (rows; on a width shard
        also columns) and gathers the rest."""
        n = imgs_u8.shape[0]
        bs = self.batch_size
        if n == 0:
            return np.zeros(imgs_u8.shape[:3], np.uint8)
        maps = torch.empty((-(-n // bs) * bs,) + imgs_u8.shape[1:3], dtype=torch.uint8,
                           device=self.device)
        for i in range(0, n, bs):
            with span("serve.batch", rows=min(bs, n - i)):
                with span("serve.copy_in"):
                    chunk = imgs_u8[i: i + bs]
                    if chunk.shape[0] < bs:  # pad the tail to the static bucket shape
                        pad = np.zeros((bs - chunk.shape[0],) + chunk.shape[1:], chunk.dtype)
                        chunk = np.concatenate([chunk, pad], 0)
                    x = torch.from_numpy(np.ascontiguousarray(shard_batch(self.mesh, chunk)))
                    tape = self._tapes.get(tuple(x.shape))
                    if tape is not None:
                        tape.x.copy_(x, non_blocking=True)
                    else:
                        x = x.to(self.device, non_blocking=True)
                with span("serve.dispatch", replayed=tape is not None):
                    if tape is not None:
                        self.stats["replayed"] += 1
                        seg = tape.replay()
                    else:
                        seg = self._eager(x)
                if self.mesh is not None:
                    with span("serve.gather"):
                        seg = self.mesh.all_gather_blocks(seg, self.geo.prep_hw[1])
                maps[i: i + bs].copy_(seg)
        with span("serve.maps_back"):
            return maps[:n].cpu().numpy()

    def predict_volume(self, volume_u8: np.ndarray,
                       native_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Full volume: batch the prepped B-scans through the bucket and,
        given ``native_hw``, postprocess each map to native resolution.
        With tracing on (``utils/tracing.py``) the volume is one request:
        a ``serve.volume`` span over its batches' spans."""
        with span("serve.volume", scans=volume_u8.shape[0]):
            segs = self.predict_scans(volume_u8)
            if native_hw is not None:
                with span("serve.postprocess"):
                    return np.stack([postprocess(self.geo, s, native_hw) for s in segs])
            return segs


def load_predictor(db: str, pt_path: Optional[str] = None, net: str = "stc_tt",
                   variant: str = "infer", batch_size: int = 8, cnn_impl: str = "plain",
                   mixer: str = "metapool", dtype: torch.dtype = torch.bfloat16, device="cuda",
                   seed: int = 0, mesh=None) -> VolumePredictor:
    """Predictor for dataset ``db`` running ``RegNet(net, variant)``:
    weights from a reference ``.pt`` file, or seeded random-init weights
    when ``pt_path`` is None.  ``net`` is any registry name
    (``models/registry.py``; ``relay`` ignores ``variant`` and ``mixer``,
    ``tcct32`` serves its own architecture with ``variant='t32'``);
    ``cnn_impl`` is ``'plain'`` or ``'fused'`` (an FTC model without MSCA);
    ``mesh`` serves data-parallel, and on a ``'model'`` axis above 1 also
    width-sharded (every rank builds the same weights)."""
    from tcct_tpu_torch.infer.importer import load_into, load_reference_pt
    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.models.layers import init_weights

    geo = get_geometry(db)
    model = RegNet(get_model(net, geo.out_channels, variant=variant, mixer=mixer),
                   out_channels=geo.out_channels)
    if pt_path:
        load_into(model, load_reference_pt(pt_path))
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return VolumePredictor(model, geo, batch_size=batch_size, dtype=dtype, device=device,
                           cnn_impl=cnn_impl, mesh=mesh)
