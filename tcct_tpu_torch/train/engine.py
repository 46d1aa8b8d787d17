"""The training engine (JAX counterpart ``tcct_tpu/train/engine.py``; the
reference's KiteSeg, task1/kite/).

The dataset's splits live on the device; an epoch gathers its batches from
the train split with ``index_select`` along a shuffled index plan, the only
thing copied to the device each epoch, and reads its metrics on the host
once, at its end.  A train split larger than the memory budget streams
from disk through the native prefetcher instead, batch by batch (the tail
batch at its natural size).  The val pass runs the split at batch size 1
and reads its sums once.

Kept from the reference and the JAX engine: the per-epoch reseed
``311 * epoch + 2023`` of the index plan (loop_seg.py:109), the val cadence
(every 10 epochs, every 5 past half of them; loop_seg.py:48), ``--bug``
truncation (12 steps an epoch, 9 val scans), the best-Dice ``val_top`` and
the ``last`` checkpoints, ``TCCT_HBM_BUDGET`` (bytes of train split above
which a split with files on disk streams; default 2 GiB) and
``TCCT_VAL_CAP`` (scans of val kept when val would not fit either).
``TCCT_STREAM_SUPERSTEP`` and ``TCCT_EPOCH_UNROLL`` have no counterpart:
they amortise the dispatch of a TPU program over several batches, and an
eager step here dispatches per op whatever the grouping.  The val pass's
flips come from one CPU generator seeded from ``(777, epoch)``, drawn as
one vector for the split (JAX folds the epoch into a PRNG key, whose values
this package cannot reproduce).

Data parallelism: ``mesh=`` (a ``parallel.DataMesh``, one process a rank)
trains on the mesh's device.  Every rank builds the same model from the
same seed, holds the whole dataset and the same epoch plan, gathers the
whole batch each step and computes its rows (``train/step.py``); the state
is broadcast from rank 0 after initialisation and after a resume or an
import (:meth:`Trainer.place_state`).  Rank 0 alone writes the checkpoints
and the metric log, each write between two barriers of the mesh.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tcct_tpu_torch.data.augment import draw_val, val_generator
from tcct_tpu_torch.data.eyeset import EyeSet
from tcct_tpu_torch.losses.polar import polar_prototypes
from tcct_tpu_torch.models.layers import init_weights
from tcct_tpu_torch.parallel.mesh import replicate
from tcct_tpu_torch.train.schedule import cyclic_lr
from tcct_tpu_torch.train.state import (
    CHECKPOINT_FILE,
    TrainState,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
)
from tcct_tpu_torch.train.step import (
    TrainConfig,
    build_eval_epoch,
    build_eval_step,
    build_train_epoch,
    build_train_step,
)
from tcct_tpu_torch.utils.logging import MetricLogger


def _means(series: Dict[str, np.ndarray]) -> Dict[str, float]:
    """An epoch's log: the mean of each metric, the last step's total and
    the sum of the totals."""
    out = {k: float(v.mean()) for k, v in series.items()}
    if "total" in series:
        out["total"] = float(series["total"][-1])
        out["los_epoch"] = float(series["total"].sum())
    return out


class Trainer:
    """Trains ``model`` (a ``RegNet``) on ``dataset`` with ``cfg`` on
    ``device``.  The model is initialised from ``seed`` (seeded random
    weights, the polarization prototypes uniform and L2-normalised); import
    weights after construction, as the CLI's ``--import_pt`` does."""

    def __init__(self, model, dataset: EyeSet, cfg: TrainConfig, root: str = "exp_tcct_tpu",
                 bs: int = 8, lr: Optional[float] = None, weight_decay: float = 2e-4,
                 seed: int = 2023, device="cuda", debug: bool = False,
                 stochastic_val: bool = True, streaming: Optional[bool] = None,
                 hbm_budget_bytes: Optional[int] = None, mesh=None):
        self.model = model
        self.dataset = dataset
        self.cfg = cfg
        self.root = root
        self.bs = bs
        self.debug = debug
        self.mesh = mesh
        if mesh is not None:
            if mesh.rank < 0:
                raise ValueError("Trainer: this rank is not a member of the mesh")
            mesh.require_data_only("Trainer")
            if bs % mesh.size != 0:
                raise ValueError(
                    f"batch size {bs} must be divisible by the {mesh.size}-device "
                    "('data',) mesh for DP training")
            device = mesh.device
        self.device = torch.device(device)
        self.writer = mesh is None or mesh.is_writer
        os.makedirs(root, exist_ok=True)
        self.logger = MetricLogger(os.path.join(root, "metrics.jsonl")) if self.writer else None

        self.steps_per_epoch = max(dataset.epoch_length("train") // bs, 1)
        if debug:
            self.steps_per_epoch = min(self.steps_per_epoch, 12)
        init = torch.Generator().manual_seed(seed)
        init_weights(model, init)
        if hasattr(model, "fcp"):
            model.fcp.buf_grad.copy_(polar_prototypes(*model.fcp.buf_grad.shape, init))
        model.to(device=self.device, memory_format=torch.channels_last)
        optimizer = make_optimizer(self.steps_per_epoch, lr=lr, weight_decay=weight_decay)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = TrainState(model, optimizer, generator)
        self.place_state()
        self.train_step = build_train_step(model, optimizer, cfg, device=self.device,
                                           generator=generator, mesh=mesh)
        self.train_epoch_fn = build_train_epoch(model, optimizer, cfg, device=self.device,
                                                generator=generator, mesh=mesh)
        self.eval_step = build_eval_step(model, cfg, stochastic_val, device=self.device,
                                         mesh=mesh)
        self.eval_epoch = build_eval_epoch(model, cfg, stochastic_val, device=self.device,
                                           mesh=mesh)

        # stream when the train split exceeds the budget and has files on disk
        if hbm_budget_bytes is None:
            hbm_budget_bytes = int(os.environ.get("TCCT_HBM_BUDGET", 2 << 30))
        train_bytes = sum(a.nbytes for a in dataset.splits["train"])
        has_paths = bool(dataset.paths.get("train"))
        if streaming is None:
            streaming = has_paths and train_bytes > hbm_budget_bytes
        if streaming and not has_paths:
            raise ValueError("streaming=True needs on-disk train paths")
        self.streaming = streaming

        # the splits on the device; a streamed train split stays on disk, and a
        # val split that would not fit either (EyeSet aliases a missing val to
        # train) keeps a fixed-seed sample of TCCT_VAL_CAP scans
        val_cap = int(os.environ.get("TCCT_VAL_CAP", 256))
        self._dev: Dict[str, Any] = {}
        for split, (im, lb) in dataset.splits.items():
            if streaming and split == "train":
                continue
            if streaming and im.nbytes + lb.nbytes > hbm_budget_bytes:
                sel = np.sort(np.random.default_rng(2023).permutation(len(im))[:val_cap])
                im, lb = im[sel], lb[sel]
            self._dev[split] = (torch.from_numpy(im).to(self.device),
                                torch.from_numpy(lb).to(self.device))
        self.best_dice = -1.0

    def place_state(self) -> None:
        """Rank 0's parameters, buffers and AdamW moments in every rank's
        state (a broadcast over the mesh; nothing without one).  Call after
        changing the state out of band: a resume, an imported checkpoint."""
        if self.mesh is None:
            return
        replicate(self.mesh, self.model)
        opt = self.state.optimizer
        if opt.mu is not None:
            replicate(self.mesh, opt.mu + opt.nu)

    def _log(self, **kv) -> None:
        if self.logger is not None:
            self.logger.log(**kv)

    def _save(self, name: str) -> None:
        save_checkpoint(self.root, self.state, name, mesh=self.mesh)

    # -- epoch loops ---------------------------------------------------------

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """The epoch's shuffled, oversampled [steps, bs] index plan, reseeded
        per the reference scheme (loop_seg.py:109)."""
        rng = np.random.default_rng(311 * epoch + 2023)
        n = len(self.dataset.splits["train"][0])
        idx = np.tile(np.arange(n), self.dataset.oversample)
        rng.shuffle(idx)
        need = self.steps_per_epoch * self.bs
        if len(idx) < need:
            idx = np.tile(idx, -(-need // max(len(idx), 1)))
        return idx[:need].reshape(self.steps_per_epoch, self.bs)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch over the device-resident train split."""
        imgs, labs = self._dev["train"]
        plan = torch.from_numpy(self._epoch_indices(epoch)).to(self.device)
        metrics = self.train_epoch_fn(imgs, labs, plan)
        self.state.epoch += 1
        return _means({k: v.cpu().double().numpy() for k, v in metrics.items()})

    def train_epoch_streaming(self, epoch: int) -> Dict[str, float]:
        """One epoch over the train files through the native prefetcher
        (``data/prefetch.py``), batch by batch, the tail batch at its natural
        size.  Logs the measured decode, stall and compute seconds."""
        from tcct_tpu_torch.data.prefetch import BatchPrefetcher

        plan = self.dataset.pairs.get("train") or []
        if not plan:
            raise RuntimeError("streaming needs on-disk train (img, lab) pairs")
        rng = np.random.default_rng(311 * epoch + 2023)
        order = np.tile(np.arange(len(plan)), self.dataset.oversample)
        rng.shuffle(order)
        plan = [plan[i] for i in order]
        if self.debug:
            plan = plan[: 12 * self.bs]
        pf = BatchPrefetcher(plan, self.dataset.geo, batch_size=self.bs, device=self.device)
        stall_s = 0.0
        series: Dict[str, list] = {}
        t_epoch = time.perf_counter()
        it = iter(pf)
        while True:
            t0 = time.perf_counter()
            nxt = next(it, None)
            stall_s += time.perf_counter() - t0
            if nxt is None:
                break
            metrics, _ = self.train_step(*nxt)
            for k, v in metrics.items():
                series.setdefault(k, []).append(v)
        self.state.epoch += 1
        out = _means({k: torch.stack(v).cpu().double().numpy() for k, v in series.items()})
        wall = time.perf_counter() - t_epoch
        out["stream_decode_s"] = round(pf.decode_s, 3)
        out["stream_decode_mb_s"] = round(pf.decoded_bytes / 1e6 / max(pf.decode_s, 1e-9), 1)
        out["stream_io_scans_per_s"] = round(pf.decoded_scans / max(pf.decode_s, 1e-9), 1)
        out["stream_stall_s"] = round(stall_s, 3)
        out["stream_compute_s"] = round(wall - stall_s, 3)
        return out

    def val(self, epoch: int = 0, bs: int = 1, max_batches: Optional[int] = None,
            compiled: Optional[bool] = None) -> Dict[str, Any]:
        """The val pass.  At batch size 1 (the default) one pass over the
        split with its sums on the device and one host read
        (``build_eval_epoch``); ``compiled=False`` runs the per-batch host
        loop of the reference instead.  Both take the same flips."""
        imgs, labs = self._dev["val"]
        n = imgs.shape[0]
        flips = draw_val(n, val_generator(epoch)).to(self.device)
        if compiled is None:
            compiled = bs == 1
        if compiled and bs == 1:
            stop = n if max_batches is None else min(n, max_batches)
            if self.debug:
                stop = min(stop, 9)  # the host loop's debug break
            m = self.eval_epoch(imgs[:stop], labs[:stop], flips[:stop])
            return {"val_f1s": float(m["val_f1s"]), "val_iou": float(m["val_iou"]),
                    "scores": np.round(m["scores"].cpu().numpy(), 4).tolist()}
        sums = {"val_f1s": 0.0, "val_iou": 0.0}
        scores = []
        count = 0
        for i in range(0, n, bs):
            if max_batches is not None and count >= max_batches:
                break
            j = min(i + bs, n)
            m = self.eval_step(imgs[i:j], labs[i:j], flips[i:j])
            sums["val_f1s"] += float(m["val_f1s"])
            sums["val_iou"] += float(m["val_iou"])
            scores.append(m["scores"].cpu().numpy())
            count += 1
            if self.debug and count > 8:
                break
        logs: Dict[str, Any] = {k: v / max(count, 1) for k, v in sums.items()}
        logs["scores"] = np.round(np.stack(scores).mean(0), 4).tolist()
        return logs

    def fit(self, epochs: int = 100) -> Dict[str, Any]:
        """Train from the state's epoch up to ``epochs``, with val at the
        cadence (every epoch in debug mode), the ``val_top`` checkpoint on a
        better val Dice and ``last`` after every epoch.  Unlike the JAX
        engine, debug mode does not cap the epochs: the CLI's ``--bug``
        asks for one."""
        t_fit = time.time()
        last_logs: Dict[str, Any] = {}
        for epoch in range(self.state.epoch, epochs):
            t0 = time.time()
            train_logs = (self.train_epoch_streaming(epoch) if self.streaming
                          else self.train_epoch(epoch))
            do_val = epoch % 10 == 0 or (epoch > 0.5 * epochs and epoch % 5 == 0)
            if do_val or self.debug:
                t_val = time.time()
                logs = self.val(epoch=epoch)
                logs["val_s"] = round(time.time() - t_val, 3)
                if logs["val_f1s"] > self.best_dice:
                    self.best_dice = logs["val_f1s"]
                    self._save("val_top")
                last_logs = logs
                self._log(epoch=epoch, **train_logs, **logs)
            else:
                self._log(epoch=epoch, **train_logs)
            self._save("last")
            dt = time.time() - t0
            if self.writer:
                print(f"{epoch:03d}* los={train_logs['los_epoch']:.4f} "
                      f"{dt / 60:.2f} min/epoch, ~{dt / 60 * (epochs - epoch - 1):.1f} min left",
                      flush=True)
        if self.writer:
            print(f"fit done in {(time.time() - t_fit) / 60:.2f} min; best dice "
                  f"{self.best_dice:.4f}", flush=True)
        return last_logs

    # -- small utilities (reference loopback.py:53-99) ------------------------

    def lr(self) -> float:
        """The cyclic schedule's learning rate at the current step
        (loopback.py islrLowerThan's input)."""
        return cyclic_lr(self.state.step // max(self.steps_per_epoch, 1))

    def is_lr_lower_than(self, thresh: float = 1e-5) -> bool:
        return self.lr() < thresh

    def weights_desc(self, key: str = "tau") -> None:
        """Print the parameters whose name contains ``key`` (loopback.py:89-93)."""
        for name, p in self.model.named_parameters():
            if key in name:
                print(name, p.detach().cpu().numpy())

    def remove_checkpoints(self, keep: str = "val_top") -> None:
        """Delete the checkpoint directories but ``keep`` (loopback.py:95-99);
        on a mesh, rank 0 deletes."""
        if not self.writer:
            return
        for name in os.listdir(self.root):
            p = os.path.join(self.root, name)
            if (os.path.isdir(p) and name != keep
                    and os.path.exists(os.path.join(p, CHECKPOINT_FILE))):
                shutil.rmtree(p)

    # -- persistence ----------------------------------------------------------

    def resume(self, name: str = "last") -> bool:
        """Load checkpoint ``name`` of ``root`` into the state; False if absent.
        Every rank of a mesh loads the same file, then rank 0's state is
        broadcast."""
        found = restore_checkpoint(self.root, self.state, name) is not None
        if found:
            self.place_state()
        return found
