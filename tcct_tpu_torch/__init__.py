"""tcct_tpu_torch — the PyTorch/CUDA port of the OCT retinal-layer
segmentation framework, for one NVIDIA H100 (Hopper, sm_90a).

It serves the FTC model family (``stc_*``, ``gtc_*``, ``cnnu``, ``pnnu``,
``vitu``; MetaPool mixer) wrapped in ``RegNet``, and trains ``stc_tt`` from
the JAX package's CLI surface:

- ``models`` — MPViT + CrossCNN dual-branch FTC, ``RegNet`` wrapper,
  registry; module and parameter names follow the reference torch
  state-dict names, so the shipped ``.pt`` checkpoints load directly.
- ``ops``    — plain PyTorch ops (pooling, resize) and the hand-written
  CUDA kernels (``ops/kernels``: MetaPool token mixer, depthwise 3x3,
  train-mode BatchNorm, fused CrossCNN block).
- ``infer``  — bucketed volume predictor and weight import.
- ``losses``, ``train`` — the paper's losses, the Dice/IoU scores, the
  train and eval steps, checkpoints and the ``Trainer`` engine.
- ``data``   — per-dataset geometry, prep/postprocess, ``EyeSet``, the
  augmentation on the device, the native PNG loader and the prefetcher.
- ``cli``    — ``python -m tcct_tpu_torch.cli.main``, the training CLI.

Public functions take NHWC tensors; modules run NCHW tensors in the
``channels_last`` memory format, so the two views share storage.  Every
entry point runs on ``device="cuda"`` unless the caller passes ``"cpu"``.
"""

__version__ = "0.1.0"
