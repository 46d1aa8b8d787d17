"""The training CLI (JAX counterpart ``tcct_tpu/cli/main.py``), the
reference's surface (task1/kite/main.py:18-49):

    python -m tcct_tpu_torch.cli.main --bs=8 --net=stc_tt --los=di --db=goals

It takes every flag of the JAX CLI with the same defaults, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels).  Differences from the JAX CLI:

- ``--packed_cnn=true`` raises: the space-to-depth lowering is the TPU's
  lane layout (the default, auto, is off here);
- the ``factor``, ``hydra`` and ``metapool2d`` mixers and gated fusion
  (``gtc_*``) in training raise (ROADMAP A.6); ``metapool_pallas`` names
  the MetaPool mixer, whose kernel runs on the card either way;
- ``--pl`` is accepted and one device is used (data parallelism is ROADMAP
  A.7); ``--gpu`` is ignored, as in the JAX CLI.
"""

from __future__ import annotations

import argparse


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Unsupported value encountered.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tcct_tpu_torch KiteOCT Argument")
    p.add_argument("--db", type=str, default="duke1",
                   choices=["duke", "duke1", "duke2", "duke3", "hcms", "hcms1", "heg", "goals",
                            "odsgh"])
    p.add_argument("--lr", type=float, default=None,
                   help="constant LR override (default: cyclic 1e-6..1e-4)")
    p.add_argument("--wd", type=float, default=2e-4, help="weight decay")
    p.add_argument("--inc", type=str, default="", help="instruction")
    p.add_argument("--gpu", type=str, default="0", help="(ignored; see --device)")
    p.add_argument("--los", type=str, default="dice", help="loss function (di/dice or mse)")
    p.add_argument("--net", type=str, default="stc_tt", help="network (see the registry)")
    p.add_argument("--pth", type=str2bool, default=True,
                   help="parsed but unused, as the reference's dead 'download weights' flag "
                        "(task1/kite/main.py:26); use --import_pt to load a torch checkpoint")
    p.add_argument("--bs", type=int, default=2, help="batch size")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--root", type=str, default="exp_tcct_tpu", help="experiment folder")
    p.add_argument("--resume", type=str2bool, default=False)
    p.add_argument("--reg", type=str2bool, default=False, help="boundary-regression loss")
    p.add_argument("--coff_reg", type=float, default=0.1)
    p.add_argument("--epl", type=str2bool, default=False, help="edge pixel loss")
    p.add_argument("--coff_epl", type=float, default=0.1)
    p.add_argument("--udh", type=str2bool, default=False, help="feature-polarization loss")
    p.add_argument("--coff_udh", type=float, default=1.0)
    p.add_argument("--type_udh", type=str, default="cos", choices=["cos", "mse"])
    p.add_argument("--ds", type=str2bool, default=False, help="deep supervision")
    p.add_argument("--coff_ds", type=float, default=1.0)
    p.add_argument("--pl", type=str2bool, default=True,
                   help="accepted; one device is used (data parallelism: ROADMAP A.7)")
    p.add_argument("--bug", type=str2bool, default=False, help="debug/smoke mode")
    p.add_argument("--data_root", type=str, default="",
                   help="dataset root (else $TCCT_DATA_ROOT or synthetic)")
    p.add_argument("--variant", type=str, default="train", choices=["train", "infer"])
    p.add_argument("--mixer", type=str, default="metapool",
                   choices=["metapool", "metapool_pallas", "metapool2d", "factor", "hydra"])
    p.add_argument("--crop", type=int, default=256, help="train crop size")
    p.add_argument("--stochastic_val", type=str2bool, default=True,
                   help="reproduce the reference's random val-time flips (octgen.py:21-25)")
    p.add_argument("--import_pt", type=str, default="",
                   help="reference torch .pt checkpoint to load before training")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "f32"],
                   help="training compute dtype (bf16: bf16 compute copies, f32 masters and "
                        "BN statistics; f32 for parity experiments)")
    p.add_argument("--packed_cnn", type=str2bool, default=None,
                   help="the JAX package's space-to-depth lowering for the TPU; not ported "
                        "(true raises)")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.packed_cnn:
        raise ValueError("--packed_cnn=true is the JAX package's space-to-depth layout for the "
                         "TPU's lane width; this package trains the CNN branch unpacked")

    import torch

    from tcct_tpu_torch.data import EyeSet
    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.train import TrainConfig, Trainer

    dataset = EyeSet.load(args.db, root=args.data_root)
    nc = dataset.out_channels
    print("OUT-CHANNELS:", nc, "| synthetic:", dataset.synthetic, flush=True)

    base = get_model(args.net, nc, variant=args.variant, mixer=args.mixer)
    if getattr(base, "flag_gate", False):
        raise NotImplementedError(f"--net {args.net}: gated fusion in training (the random alpha "
                                  "map) is not ported yet: ROADMAP A.6")
    net = RegNet(base=base, out_channels=nc, con=args.type_udh)
    cfg = TrainConfig(
        loss="di" if args.los in ("di", "dice") else "mse",
        ds=args.ds, coff_ds=args.coff_ds,
        udh=args.udh, coff_udh=args.coff_udh,
        reg=args.reg, coff_reg=args.coff_reg,
        epl=args.epl, coff_epl=args.coff_epl,
        crop_hw=(args.crop, args.crop),
        n_class=nc,
        dtype={"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype],
    )
    if args.device.startswith("cuda") and args.dtype == "f32":
        torch.backends.cudnn.allow_tf32 = False  # f32 means f32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    trainer = Trainer(net, dataset, cfg, root=args.root, bs=args.bs, lr=args.lr,
                      weight_decay=args.wd, device=args.device, debug=args.bug,
                      stochastic_val=args.stochastic_val)
    if args.import_pt:
        from tcct_tpu_torch.infer import load_reference_pt

        # partial, as the JAX CLI's import: what the file lacks keeps its init
        res = trainer.model.load_state_dict(load_reference_pt(args.import_pt), strict=False)
        print(f"imported: {len(res.missing_keys)} missing, {len(res.unexpected_keys)} "
              f"unexpected", flush=True)
    if args.resume:
        print("resumed:", trainer.resume("val_top") or trainer.resume("last"), flush=True)
    trainer.fit(epochs=1 if args.bug else args.epochs)


if __name__ == "__main__":
    main()
