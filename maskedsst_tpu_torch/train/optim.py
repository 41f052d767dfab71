"""The recipes' optimizers and schedulers on ``torch.optim``.

Finetuning:

* ``torch.optim.Adam(weight_decay=wd)``: coupled L2 added to the gradient
  before the moment estimates (the JAX package's ``_adam_l2_core``);
* two parameter groups, the classifier head at ``head_lr`` and the rest at
  ``lr``; the head is chosen by name (``head_*`` / ``mlp_head`` components,
  never the feed-forward ``fc1``/``fc2``); with ``linear_eval`` only the
  head is optimized.

Pretraining:

* ``torch.optim.AdamW(lr, betas (0.9, 0.999), eps 1e-8, weight_decay=wd)``,
  optax's ``adamw``: decoupled decay on every parameter;
* before it, every gradient clamped elementwise to [-1, 1]
  (:func:`clamp_gradients_`, the JAX chain's ``optax.clip``: a value
  clamp, not a norm clip); :func:`global_norm` of the raw gradients, taken
  before the clamp, is the ``log_grad_norm`` metric.

Schedulers: ``ReduceLROnPlateau(factor 0.9, patience 5, rel threshold
1e-4)``, stepped by the mean validation loss, or :class:`CosineAnnealingLR`
(T_max 50), whose rate is set per group in closed form each epoch. Both
have ``state_dict`` / ``load_state_dict`` (a checkpoint's sidecar).

The DeepHyperX recipes (``models/zoo.py::get_model``) name ``SGD``
(coupled L2, optax's ``trace`` momentum: torch's buffer from the first
gradient), ``Adagrad`` (:class:`Adagrad`, optax's form) and ``Adadelta``
(rho 0.9, eps 1e-6, coupled L2: torch's algorithm is optax's), each in
the same head/rest groups; the sharma recipe steps :class:`MultiStepLR`.

Groups are ordered head first, then the rest, the order in which the JAX
package's ``get_learning_rates`` reports them.

``capturable``: Adam and AdamW built so that their step can be captured
in a CUDA graph (step counters on the card, the bias corrections computed
there). A trainer on the superstep's graph route (``train/superstep.py``)
builds them so, and its eager steps and graph replays take one
arithmetic; everywhere else (the CPU, where torch refuses it, and the
eager route) they are torch's default.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence

import torch
from torch import nn


def make_head_label_fn(method_name: Optional[str] = None) -> Callable[[str], bool]:
    """Predicate on a parameter name marking classifier-head parameters:
    ``fc*`` components for the li 3-D CNN, ``head_*``/``mlp_head`` for the
    ViTs (a blanket ``fc`` prefix would catch the transformer's
    feed-forward layers)."""
    prefixes = ("fc",) if method_name == "li" else ("head_", "mlp_head")
    return lambda name: any(part.startswith(prefixes) for part in name.split("."))


class Adagrad(torch.optim.Optimizer):
    """optax ``adagrad`` after ``add_decayed_weights``: g += wd * p, a
    sum of squares from ``initial_accumulator_value``, the update
    ``lr * g * rsqrt(sum + eps)`` (0 where the sum is 0). torch's
    ``Adagrad`` divides by ``sqrt(sum) + eps`` instead; the recipe's
    defaults are torch's (accumulator 0, eps 1e-10)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.0, eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, eps=eps,
                                      initial_accumulator_value=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=group["weight_decay"]) if group["weight_decay"] else p.grad
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                total = state["sum"].add_(g * g)
                scale = torch.where(total > 0, torch.rsqrt(total + group["eps"]),
                                    torch.zeros_like(total))
                p.add_(g * scale, alpha=-group["lr"])
        return None


def _make(name: str, groups, learning_rate: float, weight_decay: float,
          momentum: float, capturable: bool = False) -> torch.optim.Optimizer:
    if name == "Adam":
        return torch.optim.Adam(groups, lr=learning_rate, weight_decay=weight_decay,
                                betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    if name == "SGD":
        return torch.optim.SGD(groups, lr=learning_rate, momentum=momentum,
                               weight_decay=weight_decay)
    if name == "Adagrad":
        return Adagrad(groups, lr=learning_rate, weight_decay=weight_decay)
    if name == "Adadelta":
        return torch.optim.Adadelta(groups, lr=learning_rate, rho=0.9, eps=1e-6,
                                    weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def build_optimizer(
    model: nn.Module,
    learning_rate: float,
    weight_decay: float = 0.0,
    *,
    name: str = "Adam",
    momentum: float = 0.0,
    head_lr: Optional[float] = None,
    head_label_fn: Optional[Callable[[str], bool]] = None,
    linear_eval: bool = False,
    capturable: bool = False,
) -> torch.optim.Optimizer:
    """The optimizer ``name`` (Adam, SGD, Adagrad or Adadelta, each with
    coupled L2; ``momentum`` for SGD) over the model's parameters, in
    head/rest groups when ``head_lr`` differs from ``learning_rate`` or
    under ``linear_eval`` (head only, at ``head_lr`` or the base lr);
    ``capturable`` for Adam."""
    named = list(model.named_parameters())
    needs_groups = linear_eval or (head_lr is not None and head_lr != learning_rate)
    if not needs_groups:
        return _make(name, [p for _, p in named], learning_rate, weight_decay, momentum,
                     capturable)
    if head_label_fn is None:
        raise ValueError("head_label_fn is required for parameter groups")
    head = [p for n, p in named if head_label_fn(n)]
    rest = [p for n, p in named if not head_label_fn(n)]
    groups = [{"params": head, "lr": head_lr if head_lr is not None else learning_rate}]
    if not linear_eval:
        groups.append({"params": rest, "lr": learning_rate})
    return _make(name, groups, learning_rate, weight_decay, momentum, capturable)


def get_learning_rates(optimizer: torch.optim.Optimizer) -> List[float]:
    return [float(g["lr"]) for g in optimizer.param_groups]


def set_learning_rates(optimizer: torch.optim.Optimizer, values: Sequence[float]) -> None:
    values = list(values)
    if len(values) != len(optimizer.param_groups):
        raise ValueError(f"{len(values)} rates for {len(optimizer.param_groups)} groups")
    for group, lr in zip(optimizer.param_groups, values):
        group["lr"] = float(lr)


def plateau_scheduler(optimizer: torch.optim.Optimizer, factor: float = 0.9,
                      patience: int = 5, threshold: float = 1e-4):
    """torch ReduceLROnPlateau with the recipe's settings (mode min, relative
    threshold, no cooldown): after ``patience`` epochs without the metric
    falling below best * (1 - threshold), every group's lr is multiplied by
    ``factor``, however small it is (``eps=0``: torch's default 1e-8 skips
    every cut once a rate is <= 1e-7, where the JAX scheduler goes on
    cutting)."""
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, mode="min", factor=factor, patience=patience, threshold=threshold,
        threshold_mode="rel", cooldown=0, min_lr=0.0, eps=0.0,
    )


def build_pretrain_optimizer(model: nn.Module, name: str, learning_rate: float,
                             weight_decay: float = 0.0,
                             capturable: bool = False) -> torch.optim.Optimizer:
    """The pretraining optimizer named by the config: ``AdamW`` (the
    recipe's), decoupled decay on every parameter; any other name of
    :func:`build_optimizer` with its coupled L2, as the JAX pretrainer
    builds them; ``capturable`` for Adam and AdamW."""
    params = list(model.parameters())
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, capturable=capturable)
    return _make(name, params, learning_rate, weight_decay, 0.0, capturable)


def clamp_gradients_(params: Iterable[torch.Tensor], bound: float) -> None:
    """Clamp every ``.grad`` elementwise to [-bound, bound], in place."""
    for p in params:
        if p.grad is not None:
            p.grad.clamp_(-bound, bound)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together, as
    one fp32 scalar where they lie (per-tensor norms, then the norm of
    those)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class CosineAnnealingLR:
    """torch ``CosineAnnealingLR(T_max, eta_min)`` in closed form, as the JAX
    package's: each ``step`` (one epoch) sets group g's rate to ``eta_min +
    (base_g - eta_min) * (1 + cos(pi * t / T_max)) / 2``, from the groups'
    rates at construction."""

    def __init__(self, optimizer: torch.optim.Optimizer, t_max: int = 50,
                 eta_min: float = 0.0):
        self.optimizer, self.t_max, self.eta_min = optimizer, t_max, eta_min
        self.bases = get_learning_rates(optimizer)
        self.epoch = 0

    def step(self) -> None:
        self.epoch += 1
        c = (1 + math.cos(math.pi * self.epoch / self.t_max)) / 2
        set_learning_rates(self.optimizer,
                           [self.eta_min + (b - self.eta_min) * c for b in self.bases])

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "bases": list(self.bases)}

    def load_state_dict(self, state: dict) -> None:
        """``bases`` None (a JAX scheduler before its first epoch) keeps the
        groups' rates at construction."""
        self.epoch = int(state["epoch"])
        if state.get("bases") is not None:
            self.bases = [float(b) for b in state["bases"]]


class MultiStepLR:
    """torch ``MultiStepLR(milestones, gamma)`` as the JAX package's: each
    ``step`` (one epoch) counts the epoch and, at a milestone, multiplies
    every group's rate by ``gamma`` (the sharma recipe). ``step`` takes and
    ignores a metric, so that it is driven as the plateau scheduler is."""

    def __init__(self, optimizer: torch.optim.Optimizer, milestones, gamma: float = 0.1):
        self.optimizer, self.gamma = optimizer, gamma
        self.milestones = sorted(int(m) for m in milestones)
        self.epoch = 0

    def step(self, metric: Optional[float] = None) -> None:
        self.epoch += 1
        if self.epoch in self.milestones:
            set_learning_rates(self.optimizer,
                               [lr * self.gamma for lr in get_learning_rates(self.optimizer)])

    def state_dict(self) -> dict:
        return {"epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])


def build_scheduler(name: Optional[str], optimizer: torch.optim.Optimizer):
    """The scheduler named by the config: ``ReduceLROnPlateau``, ``cosine``
    (T_max 50) or none; any other name raises, as in the JAX trainer."""
    if name == "ReduceLROnPlateau":
        return plateau_scheduler(optimizer)
    if name == "cosine":
        return CosineAnnealingLR(optimizer, t_max=50)
    if name in (None, "", "none", "None"):
        return None
    raise ValueError(f"unknown scheduler {name!r}: use 'ReduceLROnPlateau', 'cosine', or none")
