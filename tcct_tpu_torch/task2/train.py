"""Task-2 training (JAX counterpart ``tcct_tpu/task2/train.py``; reference
task2/t2_train.py:162-349).

Kept from the reference and the JAX package: BCEWithLogits applied to the
*softmaxed* outputs against one-hot targets (the reference's double
squash, t2_train.py:183-185: its checkpoints were trained so), Adam with
coupled L2 (lr 1e-5, weight decay 5e-4), val every 5 epochs with AUC, F1
and accuracy on hard predictions, and best-model selection by the
*validation* accuracy (the JAX package's fix of the reference's train
accuracy).

The step is f32.  Its convs run on cuDNN in full f32 (TF32 off whatever the
caller set) and on deterministic algorithms: cuDNN's default f32 weight
gradient adds with float atomics, so a step would not repeat bit for bit.
In train mode every BatchNorm is one K3 launch forward and one K3b launch
backward on the card.  Checkpoints are ``torch.save`` files of the model's
state dict (parameters and BN statistics); the JAX package's orbax
checkpoints are not read (weights cross through
``infer/importer.py::from_jax_variables``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tcct_tpu_torch.models.layers import BatchNorm2d, full_f32_cudnn, train_pass
from tcct_tpu_torch.task2.data import GoalClsSet, apply_cls_train, draw_cls_train, true_div
from tcct_tpu_torch.task2.metrics import accuracy, f1_score, roc_auc
from tcct_tpu_torch.task2.model import ClsModel, init_cls_weights, load_resnet_checkpoint
from tcct_tpu_torch.train.state import CHECKPOINT_FILE, Adam
from tcct_tpu_torch.train.step import eval_mode

NUM_CLASSES = 2


def one_hot(labels: torch.Tensor) -> torch.Tensor:
    """f32 one-hots of [B] labels; a label out of range (9, unlabelled)
    gives a zero row, as ``jax.nn.one_hot`` does."""
    return (labels.long()[:, None] == torch.arange(NUM_CLASSES, device=labels.device)).float()


def bce_on_softmax(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """``BCEWithLogitsLoss(softmax(logits), onehot)`` (t2_train.py:183-185)."""
    p = torch.softmax(logits, dim=-1)
    return torch.mean(torch.clamp(p, min=0) - p * onehot + torch.log1p(torch.exp(-torch.abs(p))))


def build_cls_train_step(model: ClsModel, optimizer: Adam, augment: bool = True, device="cuda",
                         generator: Optional[torch.Generator] = None) -> Callable:
    """``step(imgs_u8 [B,S,S,3], labels [B]) -> {"loss", "acc"}``: one f32
    train step of ``model`` (moved to ``device`` in channels_last),
    updating its parameters and BN running statistics in place.
    ``generator`` (on ``device``) draws the augmentation (with ``augment``,
    :func:`draw_cls_train`), then the four dropout masks, each at a fixed
    shape.  The metrics are 0-d f32 tensors on ``device``: no host read."""
    if generator is None:
        raise ValueError("the step's dropout (and augmentation) draw from its generator; "
                         "none was given")
    device = torch.device(device)
    model.to(device=device, memory_format=torch.channels_last).train()
    params = list(model.parameters())

    def step(imgs_u8, labels) -> Dict[str, torch.Tensor]:
        imgs = torch.as_tensor(imgs_u8).to(device)
        onehot = one_hot(torch.as_tensor(labels).to(device))
        if augment:
            img = apply_cls_train(imgs, draw_cls_train(imgs.shape[0], generator, device),
                                  imgs.shape[1])
        else:
            img = true_div(imgs.float(), 255.0)
        with full_f32_cudnn(deterministic=True):
            with train_pass(model, generator) as new_stats:
                logits = model(img.permute(0, 3, 1, 2))
            loss = bce_on_softmax(logits, onehot)
            grads = torch.autograd.grad(loss, params)
        optimizer.update(params, list(grads))
        with torch.no_grad():
            for m, (mean, var) in new_stats.items():
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
        acc = (logits.detach().argmax(-1) == onehot.argmax(-1)).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return step


def build_cls_predict(model: ClsModel, device="cuda") -> Callable:
    """``predict(imgs_u8 [B,S,S,3]) -> [B] int64``: the eval-mode model in
    full f32, softmax, argmax."""
    device = torch.device(device)

    @torch.no_grad()
    def predict(imgs_u8) -> torch.Tensor:
        img = true_div(torch.as_tensor(imgs_u8).to(device).float(), 255.0).permute(0, 3, 1, 2)
        with eval_mode(model), full_f32_cudnn():
            logits = model(img)
        return torch.argmax(torch.softmax(logits, -1), -1)

    return predict


def bn_modules(model: torch.nn.Module):
    """The model's BatchNorms in module order: one K3 and one K3b launch
    each per train step on the card."""
    return [m for m in model.modules() if isinstance(m, BatchNorm2d)]


class ClsTrainer:
    """Trains a :class:`ClsModel` on a :class:`GoalClsSet` on ``device``.
    The model is initialised from ``seed`` (:func:`init_cls_weights`), then
    grafted from ``pretrained`` or ``$TCCT_RESNET_PT`` where one is given
    (ImageNet weights; without them training starts from scratch, a
    deviation from the reference's ``pretrained=True``).  The dataset's
    images live on the device; each step gathers its batch there."""

    def __init__(self, net: str = "res18", lr: float = 1e-5, weight_decay: float = 5e-4,
                 bs: int = 8, root: str = "goals_task2", img_size: int = 224,
                 dataset: Optional[GoalClsSet] = None, seed: int = 311, debug: bool = False,
                 pretrained: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        self.model = ClsModel(net=net)
        self.bs = bs
        self.root = root
        self.debug = debug
        os.makedirs(root, exist_ok=True)
        self.dataset = dataset if dataset is not None else GoalClsSet.load(img_size=img_size)
        init_cls_weights(self.model, torch.Generator().manual_seed(seed))
        pretrained = pretrained or os.environ.get("TCCT_RESNET_PT", "")
        if pretrained:
            report = load_resnet_checkpoint(pretrained, self.model)
            print(f"pretrained backbone: {len(report.loaded)} tensors grafted, "
                  f"{len(report.unused)} unused", flush=True)
        self.optimizer = Adam(lr, weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.train_step = build_cls_train_step(self.model, self.optimizer, device=self.device,
                                               generator=self.generator)
        self.predict_fn = build_cls_predict(self.model, device=self.device)
        self.imgs_dev = torch.from_numpy(self.dataset.imgs).to(self.device)
        self.labs_dev = torch.from_numpy(self.dataset.labels).to(self.device)
        self.best_acc = -1.0

    def predict(self) -> np.ndarray:
        """Hard predictions of the whole dataset, batch by batch, one host
        read."""
        n = len(self.dataset.imgs)
        preds = [self.predict_fn(self.imgs_dev[i:i + self.bs]) for i in range(0, n, self.bs)]
        return torch.cat(preds).cpu().numpy()

    def valid(self) -> Dict[str, float]:
        """AUC, F1 and accuracy of the hard predictions over the labelled
        images (label 9 left out)."""
        preds = self.predict()
        labs = self.dataset.labels
        mask = labs != 9
        return {"auc": roc_auc(labs[mask], preds[mask]),
                "f1s": f1_score(labs[mask], preds[mask].round()),
                "acc": accuracy(labs[mask], preds[mask].round())}

    def fit(self, epochs: int = 99) -> Dict[str, float]:
        """Epochs of ``len * oversample // bs`` steps (4 steps and 1 epoch in
        debug) on batches drawn with replacement from
        ``np.random.default_rng(311)``, val at every fifth epoch from 0 and
        ``best_model`` saved on a better val accuracy.  Returns the last
        val scores."""
        n = len(self.dataset.imgs)
        steps = max(n * self.dataset.oversample // self.bs, 1)
        if self.debug:
            steps, epochs = 4, 1
        rng = np.random.default_rng(311)
        scores: Dict[str, float] = {}
        for epoch in range(epochs):
            series = []
            for _ in range(steps):
                idx = torch.from_numpy(rng.integers(0, n, self.bs)).to(self.device)
                m = self.train_step(self.imgs_dev.index_select(0, idx),
                                    self.labs_dev.index_select(0, idx))
                series.append(torch.stack([m["loss"], m["acc"]]))
            loss, acc = torch.stack(series).double().mean(0).tolist()
            print(f"[RUN] {epoch}/{epochs} loss={loss:.4f} acc={acc:.4f}", flush=True)
            if epoch % 5 == 0:
                scores = self.valid()
                print(f"[VAL] {epoch}: {scores}", flush=True)
                if scores["acc"] > self.best_acc:
                    self.best_acc = scores["acc"]
                    self.save(os.path.join(self.root, "best_model"))
        return scores

    def save(self, path: str) -> None:
        """``<path>/state.pt``: the model's parameters and BN statistics."""
        os.makedirs(path, exist_ok=True)
        torch.save({"model": self.model.state_dict()}, os.path.join(path, CHECKPOINT_FILE))

    def load(self, path: str) -> None:
        state = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state["model"])


def main(argv=None):
    """The reference's CLI (task2/t2_train.py:26-34) plus ``--device``:
    ``python -m tcct_tpu_torch.task2.train --net=res18 --lr=1e-5 --bs=8``."""
    import argparse

    p = argparse.ArgumentParser(description="GOALS Task-2 Argument")
    p.add_argument("--inc", type=str, default="")
    p.add_argument("--gpu", type=str, default="0", help="(ignored; see --device)")
    p.add_argument("--net", type=str, default="res18", choices=["res18", "res34", "res50"])
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--epochs", type=int, default=99)
    p.add_argument("--root", type=str, default="goals_task2")
    p.add_argument("--data_root", type=str, default="", help="GOALS folder (else synthetic)")
    p.add_argument("--bug", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False  # task 2 is f32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False

    ds = None
    if args.data_root:
        ds = GoalClsSet.load(
            dataset_root=os.path.join(args.data_root, "Train", "Image"),
            label_file=os.path.join(args.data_root, "Train", "Train_GC_GT.xlsx"),
            img_size=args.img_size)
    tr = ClsTrainer(net=args.net, lr=args.lr, bs=args.bs, root=args.root,
                    img_size=args.img_size, dataset=ds, debug=args.bug, device=args.device)
    scores = tr.fit(epochs=1 if args.bug else args.epochs)
    print("final:", scores, flush=True)
    return scores


if __name__ == "__main__":
    main()
