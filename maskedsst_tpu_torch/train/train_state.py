"""Training state as one small object: model, optimizer, step counter and
the generator that draws every random choice of a step (crop origin,
dropout seeds). No checkpoint format yet (ROADMAP.md)."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    rng: torch.Generator = field(default_factory=torch.Generator)
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad`` (left in
        place, for inspection, until the next step clears them)."""
        self.optimizer.step()
        self.step += 1
