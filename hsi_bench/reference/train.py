"""Steps of the SimMIM recipe in the reference: per step the draws
(``draws.py``), the crop of the step's tiles, the loss, its gradients by
autograd, every gradient clamped to [-1, 1] (the recipe's
``clip_grad_norm``), then AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled
decay, torch's bias-corrected form)."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, NamedTuple, Optional

import torch

from hsi_bench.reference.draws import draw_step
from hsi_bench.reference.model import simmim_loss
from hsi_bench.reference.quant import ROUNDINGS

BETAS, EPS = (0.9, 0.999), 1e-8
Leaves = Dict[str, torch.Tensor]


class Start(NamedTuple):
    """Where the followed steps begin: the parameters, AdamW's moments
    (None: zero, before the first update) and the updates already made."""

    params: Leaves
    exp_avg: Optional[Leaves] = None
    exp_avg_sq: Optional[Leaves] = None
    step: int = 0


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 products in float32 (TF32 off), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _norms(leaves: Leaves) -> Dict[str, float]:
    return {k: float(t.norm()) for k, t in leaves.items()}


def follow(start: Start, tiles: Callable[[int], torch.Tensor], steps: int, cfg: dict,
           trainer_seed: int, rounding: str = "float32", rows: Optional[int] = None) -> dict:
    """``steps`` updates after the ``start.step`` already made: update t
    (counted from 1 over the whole run) on ``tiles(t)`` [B, C, T, T], its
    draws the t-th from a generator seeded with ``trainer_seed`` (those of
    the updates before ``start`` drawn and passed over). ``rows``: only
    the first ``rows`` cubes of each batch enter the loss (a fault: part of
    the batch left out). Returns ``losses`` [steps], ``grad_norms`` (each
    leaf's norm of the first followed update's clamped gradient),
    ``change_norms`` (each leaf's norm of its change over the steps) and
    ``moment_norms`` (each leaf's norm of AdamW's first moment after
    them)."""
    q = ROUNDINGS[rounding]
    s = int(cfg["image_size"])
    lr, wd = float(cfg["lr"]), float(cfg["weight_decay"])
    if not cfg.get("tube_masking") or cfg.get("optimizer") != "AdamW":
        raise ValueError("the reference follows the recipe: tube masks and AdamW")
    rng = torch.Generator().manual_seed(int(trainer_seed))
    first = tiles(start.step + 1)
    batch, tile, device = first.shape[0], first.shape[-1], first.device
    for _ in range(start.step):
        draw_step(rng, cfg, batch, tile, device)
    names = list(start.params)
    params = [start.params[k].detach().clone().float().requires_grad_() for k in names]
    m = [torch.zeros_like(p) if start.exp_avg is None else start.exp_avg[k].detach().clone().float()
         for k, p in zip(names, params)]
    v = [torch.zeros_like(p) if start.exp_avg_sq is None
         else start.exp_avg_sq[k].detach().clone().float() for k, p in zip(names, params)]
    losses, grad_norms = [], {}
    with no_tf32():
        for t in range(start.step + 1, start.step + steps + 1):
            d = draw_step(rng, cfg, batch, tile, device)
            img = first if t == start.step + 1 else tiles(t)
            if d.xy is not None:
                x0, y0 = d.xy
                img = img[:, :, x0 : x0 + s, y0 : y0 + s]
            else:
                img = img[:, :, :s, :s]
            mask = d.mask
            if rows is not None:
                img, mask = img[:rows], mask[:rows]
            w = dict(zip(names, params))
            loss = simmim_loss(img, w, cfg, mask, d.layer_seeds, q)
            grads = torch.autograd.grad(loss, params)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                grads = [gr.clamp(-1.0, 1.0) if cfg.get("clip_grad_norm") else gr for gr in grads]
                if t == start.step + 1:
                    grad_norms = {k: float(gr.norm()) for k, gr in zip(names, grads)}
                bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
                for p, gr, mi, vi in zip(params, grads, m, v):
                    p.mul_(1 - lr * wd)
                    mi.mul_(BETAS[0]).add_(gr, alpha=1 - BETAS[0])
                    vi.mul_(BETAS[1]).addcmul_(gr, gr, value=1 - BETAS[1])
                    denom = (vi.sqrt() / bc2**0.5).add_(EPS)
                    p.addcdiv_(mi, denom, value=-lr / bc1)
    with torch.no_grad():
        change = {k: p - start.params[k].float() for k, p in zip(names, params)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": _norms(change),
            "moment_norms": _norms(dict(zip(names, m)))}
