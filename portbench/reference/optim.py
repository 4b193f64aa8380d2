"""Plain optimizer of the configuration: gradients clipped to a global norm
(scaled by clip/norm once the norm reaches ``clip``), then Adam (β 0.9,
0.999, ε 1e-8 added to √v̂) at a warmup-cosine rate: linear from 0 over
the warmup, a cosine to 0.01 of the peak at the run's last step, with the
rate of update i taken at i before it is counted (the first update moves
nothing but fills the moments)."""

from __future__ import annotations

import math

import torch

__all__ = ["learning_rate", "Adam"]


def learning_rate(i: int, peak: float, warmup: int, steps: int) -> float:
    if warmup <= 0:
        return peak
    if i < warmup:
        return peak * i / warmup
    decay = max(steps, warmup + 1) - warmup
    t = min(i - warmup, decay)
    return peak * (0.99 * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + 0.01)


class Adam:
    def __init__(self, params: dict, clip: float, peak: float, warmup: int, steps: int,
                 state=None):
        """``state``: (first moments, second moments, updates made) to go on
        from, as dicts by parameter name; fresh (zeros, zeros, 0) without."""
        self.params = params
        self.clip, self.peak, self.warmup, self.steps = clip, peak, warmup, steps
        if state is None:
            state = ({k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()}, 0)
        m, v, self.t = state
        self.m = {k: m[k].detach().clone().float() for k in params}
        self.v = {k: v[k].detach().clone().float() for k in params}

    def clipped(self, grads: dict) -> dict:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if self.clip > 0 and float(norm) >= self.clip:
            return {k: g * (self.clip / norm).float() for k, g in grads.items()}
        return grads

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Clip, update every parameter in place; returns the clipped grads."""
        grads = self.clipped(grads)
        lr = learning_rate(self.t, self.peak, self.warmup, self.steps)
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(1e-8)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
        return grads
