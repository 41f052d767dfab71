"""Training state as one small object: model, optimizer, step counter and
the generator that draws every random choice of a step (crop origin, mask
seed, dropout seeds). ``state_dict`` / ``load_state_dict`` carry all four,
which is what makes a resume from ``train/checkpoint.py`` exact."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

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

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "rng": self.rng.get_state()}

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        self.model.load_state_dict(payload["model"])
        opt = payload["optimizer"]
        # a load takes the saved groups' flags: keep this optimizer's own
        # ``capturable`` (a card run saves True, a CPU run False), so that a
        # file moves between the card and the CPU
        capturable = [g.get("capturable", False) for g in self.optimizer.param_groups]
        if len(capturable) == len(opt["param_groups"]):
            opt = {**opt, "param_groups": [
                {**g, "capturable": c} if "capturable" in g else g
                for g, c in zip(opt["param_groups"], capturable)]}
        # torch keeps the step counters of an optimizer that is neither
        # fused nor capturable on the CPU, and a load leaves them where the
        # payload was mapped: put them back. A capturable optimizer keeps
        # them on the card (the load moves them beside their parameters).
        if not any(capturable):
            for s in opt["state"].values():
                if isinstance(s.get("step"), torch.Tensor):
                    s["step"] = s["step"].cpu()
        self.optimizer.load_state_dict(opt)
        self.rng.set_state(payload["rng"].cpu())  # a CPU generator
        self.step = int(payload["step"])
