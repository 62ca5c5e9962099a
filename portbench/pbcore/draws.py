"""The RANSAC uniforms of a pair, made from the run's seed.

`match_images(..., draws=d)` asks `d(name, shape)` for every uniform of
every step.  One PairDraws serves one call: a fresh one for the same seed
and pool index hands out the same uniforms in the same order, so each
repeat of a pool pair, and the reference, verify with the same draws."""
from __future__ import annotations

import numpy as np
import torch


class PairDraws:
    def __init__(self, seed: int, index: int, device):
        state = np.random.SeedSequence([int(seed) % (1 << 63), 0xD4A5, index])
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(state.generate_state(1, dtype=np.uint64)[0]) >> 1)
        self.device = device

    def __call__(self, name, shape):
        return torch.rand(tuple(shape), generator=self.gen, device=self.device)
