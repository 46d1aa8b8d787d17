"""tcct_tpu_torch — the PyTorch/CUDA port of the OCT retinal-layer
segmentation framework, for one NVIDIA H100 (Hopper, sm_90a).

It serves and trains the JAX package's model zoo (the FTC family ``stc_*``,
``gtc_*``, ``cnnu``, ``pnnu``, ``vitu``, ``msca``, ``tcct32`` with every token
mixer, and the ReLayNet baseline ``relay``) wrapped in ``RegNet``, from the
JAX package's CLI surface:

- ``models`` — MPViT + CrossCNN dual-branch FTC, ReLayNet, MSCA, the
  ``RegNet`` wrapper, the registry; module and parameter names follow the
  reference torch state-dict names, so the shipped ``.pt`` checkpoints load
  directly.
- ``ops``    — plain PyTorch ops (pooling, resize) and the hand-written
  CUDA kernels (``ops/kernels``: MetaPool token mixer, depthwise 3x3,
  train-mode BatchNorm, fused CrossCNN block).
- ``infer``  — bucketed volume predictor and weight import.
- ``losses``, ``train`` — the paper's losses, the Dice/IoU scores, the
  train and eval steps, checkpoints and the ``Trainer`` engine.
- ``data``   — per-dataset geometry, prep/postprocess, ``EyeSet``, the
  augmentation on the device, the native PNG loader and the prefetcher.
- ``cli``    — ``python -m tcct_tpu_torch.cli.main``, the training CLI.
- ``parallel`` — data parallelism over ``torch.distributed`` (one process a
  device): process groups, the ``('data',)`` mesh, the collectives of the
  data-parallel step, ``--pl``.
- ``task2``  — task 2, the GOALS glaucoma classifier: a ResNet-18/34/50 with
  per-stage dropout, its data (PNG prep and xlsx labels without cv2 or
  pandas) and augmentation on the device, ``ClsTrainer``, the TTA ensemble,
  the metrics, and the CLIs ``python -m tcct_tpu_torch.task2.train`` and
  ``python -m tcct_tpu_torch.task2.ensemble``.

Public functions take NHWC tensors; modules run NCHW tensors in the
``channels_last`` memory format, so the two views share storage.  Every
entry point runs on ``device="cuda"`` unless the caller passes ``"cpu"``.
"""

__version__ = "0.1.0"
