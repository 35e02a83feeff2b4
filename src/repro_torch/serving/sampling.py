"""Non-greedy sampling for the serving engine (``repro.serving.sampling``
counterpart, in torch).

OFF BY DEFAULT: an engine without a `SamplingParams` takes ``argmax``, so
every greedy parity check against the JAX package stays valid.

With sampling enabled, randomness is PER-REQUEST STATE: each admitted
request gets its own ``torch.Generator`` on the engine's device, seeded
from ``(seed, request counter)`` (`request_generator`), and every token it
samples consumes exactly one uniform draw of that generator.  Inactive
slots draw nothing, so a request's token stream depends on nothing but its
own generator and its own logits: co-batched traffic and the admission
order of OTHER requests cannot perturb it.  The JAX package derives its
per-request keys with ``jax.random.fold_in``, which torch cannot
reproduce: sampled tokens are held to seed-determinism within the port,
not to the JAX package's.

Temperature scales the logits (``logits / max(temperature, 1e-6)``);
``top_p`` < 1 applies nucleus filtering BEFORE sampling, with the JAX
package's rule (`top_p_filter`): tokens are ranked by logit and kept while
the cumulative probability of strictly higher-ranked tokens is below
``top_p`` (the top-1 token always survives, so ``top_p -> 0`` degenerates
to greedy).  A token is then drawn by inverting the cumulative
distribution at the request's uniform draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Engine-level sampling configuration (one policy per engine run).

    ``temperature`` > 0 softens/sharpens the distribution; ``top_p`` in
    (0, 1] keeps the smallest logit-ranked nucleus with cumulative
    probability >= top_p; ``seed`` derives every request's generator —
    two runs with the same seed over the same trace sample identical
    tokens."""
    temperature: float = 1.0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if not (self.temperature > 0.0):
            raise ValueError(f"temperature must be > 0 (greedy decoding is "
                             f"sampling=None), got {self.temperature}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def request_generator(seed: int, counter: int, device) -> torch.Generator:
    """The generator of the ``counter``-th admitted request: an independent
    stream per ``(seed, counter)`` pair."""
    state = np.random.SeedSequence([int(seed), int(counter)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return gen


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """``logits`` (B, V) float32 with every token outside the nucleus set
    to -inf, by the JAX package's rule: sort descending, keep rank r while
    the probability mass of ranks < r is below ``top_p``, then keep every
    logit at or above the smallest kept one."""
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    kth = srt.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < kth, float("-inf"))


def sample_tokens(logits: torch.Tensor,
                  gens: Sequence[Optional[torch.Generator]],
                  params: SamplingParams) -> torch.Tensor:
    """One token per row of ``logits`` (B, V): rows with a generator in
    ``gens`` sample (one uniform draw of that generator each); rows with
    None (free or padding rows, whose token is unused) draw nothing and
    take the token at draw 0.  Returns (B,) int64 on the logits'
    device."""
    l = logits.to(torch.float32) / max(params.temperature, 1e-6)
    if params.top_p < 1.0:
        l = top_p_filter(l, params.top_p)
    dev = l.device
    zero = torch.zeros((), device=dev)
    u = torch.stack([torch.rand((), generator=g, device=dev)
                     if g is not None else zero for g in gens])
    cdf = torch.cumsum(torch.softmax(l, dim=-1), dim=-1)
    x = (u * cdf[:, -1]).unsqueeze(1)
    tok = torch.searchsorted(cdf, x, right=True).squeeze(1)
    return tok.clamp_max(l.shape[-1] - 1)
