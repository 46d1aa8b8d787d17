"""Seeded synthetic OCT B-scans and the benchmark's random weights, made on
the device in a few large calls.

A scan is layered as a retina is: per column ``n_class - 1`` boundaries at
seeded depths (a random start, seeded gaps of 5-15 % of the height, a seeded
sine across the width), class k between boundaries k and k + 1, and an
image that is each class's grey level plus Gaussian noise.  Every class
covers at least 5 % of each column, so no class map is a near-tie of
uniform noise.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for one use of a run's seed: ``stream``
    names the use (scans, weights, the step's draws, ...)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)


def banded(n: int, hw, n_class: int, gen: torch.Generator, device):
    """``n`` seeded scans: uint8 images [n, H, W, 3] and labels [n, H, W]
    on ``device``."""
    H, W = hw

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    start = u(n, 1, 1, lo=0.1 * H, hi=0.25 * H)
    gaps = u(n, n_class - 1, 1, lo=0.05 * H, hi=0.15 * H)
    cols = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    wave = 0.05 * H * torch.sin(2 * math.pi * cols / W * u(n, 1, 1, lo=0.5, hi=2.0)
                                + u(n, 1, 1, hi=2 * math.pi))
    bounds = start + torch.cumsum(gaps, dim=1) - gaps[:, :1] + wave  # [n, n_class - 1, W]
    rows = torch.arange(H, device=device, dtype=torch.float32)[None, :, None, None]
    labs = (rows >= bounds.permute(0, 2, 1)[:, None]).sum(-1).to(torch.uint8)  # [n, H, W]
    grey = torch.linspace(40, 220, n_class, device=device)[labs.long()]
    noise = torch.randn((n, H, W, 3), generator=gen, device=device) * 20
    imgs = torch.clamp(grey[..., None] + noise, 0, 255).to(torch.uint8)
    return imgs, labs


@torch.no_grad()
def fill_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights for every parameter and buffer of ``model`` (on the
    generator's device), from one normal and one uniform draw: convolutions
    He-normal over fan-out, linear layers N(0, 0.02), biases N(0, 0.02),
    norm affines 1 + N(0, 0.1) and N(0, 0.05), BatchNorm statistics
    N(0, 0.05) and 1 + U(0, 0.2), the polarization prototypes unit rows of
    uniforms."""
    named = dict(model.named_parameters())
    named.update(dict(model.named_buffers()))
    floats = {k: t for k, t in named.items() if t.is_floating_point()}
    total = sum(t.numel() for t in floats.values())
    z = torch.randn(total, generator=gen, device=gen.device)
    r = torch.rand(total, generator=gen, device=gen.device)
    off = 0
    for k, t in floats.items():
        n = t.numel()
        zk, rk = z[off:off + n].view(t.shape), r[off:off + n].view(t.shape)
        off += n
        leaf = k.rsplit(".", 1)[-1]
        if k.endswith("fcp.buf_grad"):
            v = rk / torch.linalg.vector_norm(rk, dim=-1, keepdim=True)
        elif k.startswith("fcp.") or leaf == "num_batches_tracked":
            v = torch.zeros_like(t)
        elif leaf == "tau":
            v = torch.full_like(t, 100.0)
        elif leaf == "running_mean":
            v = 0.05 * zk
        elif leaf == "running_var":
            v = 1.0 + 0.2 * rk
        elif leaf == "weight" and t.dim() == 4:
            v = zk * math.sqrt(2.0 / (t.shape[0] * t.shape[2] * t.shape[3]))
        elif leaf == "weight" and t.dim() == 2:
            v = 0.02 * zk
        elif leaf == "weight":  # BatchNorm and LayerNorm scales
            v = 1.0 + 0.1 * zk
        elif _is_norm_bias(model, k):
            v = 0.05 * zk
        else:
            v = 0.02 * zk
        t.copy_(v)


def _is_norm_bias(model: torch.nn.Module, key: str) -> bool:
    mod = model.get_submodule(key.rsplit(".", 1)[0])
    return isinstance(mod, (torch.nn.BatchNorm2d, torch.nn.LayerNorm))
