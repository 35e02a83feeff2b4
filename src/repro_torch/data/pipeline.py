"""Deterministic synthetic tasks (``repro.data.pipeline`` counterparts),
standing in for datasets with their geometry:

  images: class-conditional Gaussian prototypes plus noise and a mild
          random gain (CIFAR-10 / Tiny-ImageNet / VWW); a CNN must learn
          the prototypes to classify, so accuracy is meaningful and
          degrades with quantization noise.
  tokens: ``x_{t+1} = perm[x_t]`` under a fixed random permutation, with
          10 % of the steps replaced by a uniform token, so an LM's loss
          falls with capacity.

Every batch is a pure function of (seed, step, shard), drawn from a
``torch.Generator`` on the requested device, so a restart at step k and
an elastic reshard resume the exact stream.  The token permutation is
numpy's ``default_rng(seed).permutation``, the JAX package's, bit for
bit; the rest of both streams is the port's own (it cannot equal the JAX
package's threefry stream), so parity tests feed the JAX package's
batches.  Batches are NHWC float32 images with int64 labels, and int64
(tokens, targets).
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


def keyed_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` (numpy's
    SeedSequence mixes them into one 63-bit seed)."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(
        2, dtype=np.uint32).view(np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)


def _prototypes(cfg: ImageTaskConfig, device) -> torch.Tensor:
    gen = keyed_generator(device, cfg.seed)
    return torch.randn((cfg.n_classes, *cfg.img_hw, cfg.in_ch),
                       generator=gen, device=device) * 0.7


def image_batch(cfg: ImageTaskConfig, step: int, batch: int,
                shard: int = 0, n_shards: int = 1, device="cuda"):
    """Deterministic labeled image batch ``(x (B, H, W, C), labels (B,))``
    of (step, shard) on ``device`` (the card unless the caller asks for
    the CPU)."""
    device = torch.device(device)
    protos = _prototypes(cfg, device)
    gen = keyed_generator(device, cfg.seed + 1, step, shard)
    labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen,
                           device=device)
    noise = cfg.noise * torch.randn((batch, *cfg.img_hw, cfg.in_ch),
                                    generator=gen, device=device)
    # mild random gain so that one pixel does not separate the classes
    gain = 1.0 + 0.1 * torch.randn((batch, 1, 1, 1), generator=gen,
                                   device=device)
    return protos[labels] * gain + noise, labels


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab: int
    seed: int = 4321


def token_permutation(cfg: TokenTaskConfig) -> np.ndarray:
    """The hidden next-token map (the JAX package's, bit for bit)."""
    return np.random.default_rng(cfg.seed).permutation(cfg.vocab)


def token_batch(cfg: TokenTaskConfig, step: int, batch: int, seq_len: int,
                shard: int = 0, n_shards: int = 1, device="cuda"):
    """Deterministic LM batch of (step, shard) on ``device``: tokens
    follow ``x_{t+1} = perm[x_t]`` with 10 % uniform corruption; returns
    (tokens, targets) of shape (batch, seq_len), targets the tokens
    shifted by one."""
    device = torch.device(device)
    perm = torch.from_numpy(token_permutation(cfg)).to(device)
    gen = keyed_generator(device, cfg.seed + 7, step, shard)
    x = torch.randint(0, cfg.vocab, (batch,), generator=gen, device=device)
    corrupt = torch.rand((seq_len, batch), generator=gen,
                         device=device) < 0.1
    rand = torch.randint(0, cfg.vocab, (seq_len, batch), generator=gen,
                         device=device)
    seq = [x]
    for t in range(seq_len):
        seq.append(torch.where(corrupt[t], rand[t], perm[seq[-1]]))
    seq = torch.stack(seq, dim=1)                 # (batch, seq_len + 1)
    return seq[:, :-1], seq[:, 1:]


class ShardedLoader:
    """Host-side loader of this process's shard of the global batch
    (``batch // n_shards`` rows).  Deterministic in the step: after a
    restart at step k, iteration resumes with identical batches;
    `reshard` changes the shard without replaying data."""

    def __init__(self, kind: str, cfg, batch: int, seq_len: int | None = None,
                 shard: int = 0, n_shards: int = 1, device="cuda"):
        self.kind, self.cfg, self.batch = kind, cfg, batch
        self.seq_len = seq_len
        self.shard, self.n_shards = shard, n_shards
        self.device = device

    def reshard(self, shard: int, n_shards: int):
        self.shard, self.n_shards = shard, n_shards

    def get(self, step: int):
        local = self.batch // self.n_shards
        if self.kind == "image":
            return image_batch(self.cfg, step, local, self.shard,
                               self.n_shards, device=self.device)
        return token_batch(self.cfg, step, local, self.seq_len, self.shard,
                           self.n_shards, device=self.device)
