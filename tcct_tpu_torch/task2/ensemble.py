"""Task-2 TTA and checkpoint ensemble (JAX counterpart
``tcct_tpu/task2/ensemble.py``; reference task2/t2_ensemble.py).

Per checkpoint the predictions are averaged over four flips (none, H, W,
both; t2_ensemble.py:130-134), run as ONE eval forward of a [4B] batch.
The per-model CSVs are then averaged and rounded into the final
submission (t2_ensemble.py:178-190).  CSV IO is the standard library's,
the files byte for byte the JAX package's.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from tcct_tpu_torch.models.layers import full_f32_cudnn
from tcct_tpu_torch.task2.data import true_div
from tcct_tpu_torch.task2.model import ClsModel
from tcct_tpu_torch.train.step import eval_mode


def build_tta_predict(model: ClsModel, device="cuda") -> Callable:
    """``tta(imgs_u8 [B,S,S,3]) -> [B] f32``: the mean over the four flips
    of the softmax argmax, from one eval forward of the [4B] batch (in
    full f32)."""
    device = torch.device(device)

    @torch.no_grad()
    def predict(imgs_u8) -> torch.Tensor:
        img = true_div(torch.as_tensor(imgs_u8).to(device).float(), 255.0)
        B = img.shape[0]
        variants = torch.cat([img, img.flip(1), img.flip(2), img.flip(1).flip(2)])
        with eval_mode(model), full_f32_cudnn():
            logits = model(variants.permute(0, 3, 1, 2))
        preds = torch.argmax(torch.softmax(logits, -1), -1).float().reshape(4, B)
        return torch.mean(preds, dim=0)

    return predict


def write_csv(path: str, names: Sequence[str], preds: Sequence[float]):
    rows = sorted(zip(names, preds))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ImgName", "GC Pred"])
        w.writerows(rows)


def read_csv(path: str) -> Dict[str, float]:
    with open(path) as f:
        r = csv.DictReader(f)
        return {row["ImgName"]: float(row["GC Pred"]) for row in r}


def ensemble_csvs(csv_paths: Sequence[str], out_path: str) -> Dict[str, int]:
    """Mean the per-model prediction CSVs and round to the final label
    (t2_ensemble.py:180-190)."""
    acc: Dict[str, float] = {}
    for p in csv_paths:
        for name, v in read_csv(p).items():
            acc[name] = acc.get(name, 0.0) + v
    final = {k: int(round(v / len(csv_paths))) for k, v in sorted(acc.items())}
    write_csv(out_path, list(final.keys()), list(final.values()))
    return final


def net_of(path: str) -> str:
    """The network a checkpoint folder's name says (as the JAX CLI reads it)."""
    return "res34" if "res34" in path else "res50" if "res50" in path else "res18"


def main(argv=None):
    """t2_ensemble.py's CLI plus ``--device``: per-checkpoint TTA CSVs, then
    the mean-and-round ensemble."""
    import argparse

    from tcct_tpu_torch.task2.data import GoalClsSet
    from tcct_tpu_torch.task2.train import ClsTrainer

    p = argparse.ArgumentParser(description="GOALS Task-2 TTA ensemble")
    p.add_argument("--weights", type=str, default="task2/weights",
                   help="folder of per-model checkpoint dirs (name contains res18/res34/res50)")
    p.add_argument("--data_root", type=str, default="", help="GOALS folder (else synthetic)")
    p.add_argument("--out", type=str, default="task2/prediction")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    ds = (GoalClsSet.load(dataset_root=os.path.join(args.data_root, "Validation", "Image"),
                          img_size=args.img_size)
          if args.data_root else GoalClsSet.load(img_size=args.img_size))
    csvs = []
    for i, ck in enumerate(sorted(glob.glob(os.path.join(args.weights, "*")))):
        tr = ClsTrainer(net=net_of(ck), img_size=args.img_size, dataset=ds, root=args.out,
                        device=args.device)
        tr.load(ck)
        tta = build_tta_predict(tr.model, device=args.device)
        preds = [tta(tr.imgs_dev[j:j + 8]) for j in range(0, len(ds.imgs), 8)]
        csv_path = os.path.join(args.out, f"Classification_Results{i}.csv")
        write_csv(csv_path, ds.names, list(torch.cat(preds).cpu().numpy().astype(np.float32)))
        csvs.append(csv_path)
        print("tta4:", ck, "->", csv_path, flush=True)
    if not csvs:
        print("no checkpoints found under", args.weights, flush=True)
        return {}
    final = ensemble_csvs(csvs, os.path.join(args.out, "Classification_Results.csv"))
    print("ensemble:", list(final.items())[:5], "...", flush=True)
    return final


if __name__ == "__main__":
    main()
