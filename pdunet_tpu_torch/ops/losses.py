"""Training losses (port of ``pdunet_tpu/ops/losses.py``).

Each reduces |d| or |d|² of the residual d = pred − target, so a complex
residual (radial MRI) gives a real scalar; for real inputs |d|² = d².
"""

from __future__ import annotations

import torch

__all__ = ["l1", "l2", "charbonnier", "LOSSES"]


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target) ** 2)


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Smooth L1: sqrt(|d|² + eps²), kinder than |d| at zero under bf16."""
    return torch.mean(torch.sqrt(torch.abs(pred - target) ** 2 + eps * eps))


#: ``TrainConfig.loss`` → loss function
LOSSES = {"l1": l1, "l2": l2, "charbonnier": charbonnier}
