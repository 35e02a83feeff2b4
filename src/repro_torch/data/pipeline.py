"""The synthetic image task (``repro.data.pipeline`` counterparts, image
half): class-conditional Gaussian prototypes plus noise and a mild random
gain, standing in for CIFAR-10 / Tiny-ImageNet / VWW with their geometry.
A CNN must learn the prototypes to classify, so accuracy is meaningful
and degrades with quantization noise.

Every batch is a pure function of (seed, step, shard), drawn from a
``torch.Generator`` on the requested device.  The stream is the port's
own: it cannot equal the JAX package's threefry stream, so parity tests
feed the JAX package's batches.  Batches are NHWC float32 images and
int64 labels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ImageTaskConfig:
    n_classes: int
    img_hw: tuple
    in_ch: int = 3
    noise: float = 0.35
    seed: int = 1234


def _generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` (numpy's
    SeedSequence mixes them into one 63-bit seed)."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(
        2, dtype=np.uint32).view(np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)


def _prototypes(cfg: ImageTaskConfig, device) -> torch.Tensor:
    gen = _generator(device, cfg.seed)
    return torch.randn((cfg.n_classes, *cfg.img_hw, cfg.in_ch),
                       generator=gen, device=device) * 0.7


def image_batch(cfg: ImageTaskConfig, step: int, batch: int,
                shard: int = 0, n_shards: int = 1, device="cuda"):
    """Deterministic labeled image batch ``(x (B, H, W, C), labels (B,))``
    of (step, shard) on ``device`` (the card unless the caller asks for
    the CPU)."""
    device = torch.device(device)
    protos = _prototypes(cfg, device)
    gen = _generator(device, cfg.seed + 1, step, shard)
    labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen,
                           device=device)
    noise = cfg.noise * torch.randn((batch, *cfg.img_hw, cfg.in_ch),
                                    generator=gen, device=device)
    # mild random gain so that one pixel does not separate the classes
    gain = 1.0 + 0.1 * torch.randn((batch, 1, 1, 1), generator=gen,
                                   device=device)
    return protos[labels] * gain + noise, labels
