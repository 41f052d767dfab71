"""Experiment tracking and throughput metering, the JAX package's
``utils/tracking.py`` on torch.

``Tracker`` logs step-keyed scalars: to stdout (one ``[project] step N:
k=v ...`` line a row) and, given ``jsonl_path``, one JSON object a row
(``{"step": N, ...}``). wandb is opt-in: the gate opens for
``use_wandb=True``, for ``WANDB_MODE`` set to anything but ``disabled``,
or under a sweep agent (``WANDB_SWEEP_ID`` / ``WANDB_RUN_ID``), and only
then is ``wandb`` imported. A failed ``wandb.init`` says so and logs to
stdout. Under ``torch.distributed`` only rank 0 writes: other ranks are
quiet, write no JSONL and carry the run id ``nonprimary-<rank>``, which
never names a directory.

``Throughput`` meters steps/s and items/s: ``stats()`` since ``start()``,
``window_stats()`` since the previous call, and ``rates_for_chunk``, the
trainers' per-boundary reading. The rates are host-clock windows; the
trainers read them right after a logging boundary's loss fetch, which
waits for the card.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class Tracker:
    def __init__(
        self,
        project: str,
        config: Optional[Any] = None,
        use_wandb: Optional[bool] = None,
        jsonl_path: Optional[str] = None,
        quiet: bool = False,
    ):
        self.project = project
        self.quiet = quiet
        self.jsonl_path = jsonl_path
        self._wandb = None
        # the pid keeps two runs started in the same second apart (their
        # checkpoints go to models_dir/run_id)
        self.run_id = f"local-{int(time.time())}-{os.getpid()}"
        rank = _process_index()
        if rank != 0:
            use_wandb = False
            self.jsonl_path = None
            self.quiet = True
            self.run_id = f"nonprimary-{rank}"
        if use_wandb is None:
            # a sweep agent sets its ids but not WANDB_MODE; its trial's
            # overrides live in wandb.config, behind this gate
            agent_driven = bool(
                os.environ.get("WANDB_SWEEP_ID") or os.environ.get("WANDB_RUN_ID")
            )
            use_wandb = agent_driven or os.environ.get("WANDB_MODE", "disabled") != "disabled"
        if use_wandb:
            try:
                import wandb

                cfg = config.to_dict() if hasattr(config, "to_dict") else config
                run = wandb.init(project=project, config=cfg, save_code=True)
                self._wandb = wandb
                self.run_id = run.id
            except Exception as exc:
                # loud: under a sweep agent, losing wandb also loses the
                # trial's wandb.config overrides
                print(f"[tracking] wandb.init failed ({exc!r}); logging to stdout only")
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        metrics = {k: _to_float(v) for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"step": step, **metrics}) + "\n")
        if not self.quiet and self._wandb is None:
            msg = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in metrics.items())
            print(f"[{self.project}] step {step}: {msg}", flush=True)

    def update_config(self, config: Any) -> None:
        if self._wandb is not None:
            cfg = config.to_dict() if hasattr(config, "to_dict") else config
            self._wandb.config.update(cfg, allow_val_change=True)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


class Throughput:
    """steps/s and items/s: ``stats()`` is cumulative since ``start()``
    (first-step warm-up included), ``window_stats()`` covers the time since
    its previous call and resets the window."""

    def __init__(self, items_per_step: int, num_chips: int = 1):
        self.items_per_step = items_per_step
        self.num_chips = max(num_chips, 1)
        self._t0: Optional[float] = None
        self._steps = 0
        self._win_t: Optional[float] = None
        self._win_steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._win_t = self._t0
        self._win_steps = 0

    def tick(self, n: int = 1) -> None:
        if self._t0 is None:
            self.start()
        self._steps += n
        self._win_steps += n

    def _rates(self, steps: int, dt: float) -> Dict[str, float]:
        sps = steps / max(dt, 1e-9)
        return {
            "steps_per_sec": sps,
            "items_per_sec": sps * self.items_per_step,
            "items_per_sec_per_chip": sps * self.items_per_step / self.num_chips,
        }

    def stats(self) -> Dict[str, float]:
        if self._t0 is None or self._steps == 0:
            return {}
        return self._rates(self._steps, time.perf_counter() - self._t0)

    def window_stats(self) -> Dict[str, float]:
        if self._win_t is None or self._win_steps == 0:
            return {}
        now = time.perf_counter()
        out = self._rates(self._win_steps, now - self._win_t)
        self._win_t = now
        self._win_steps = 0
        return out

    def rates_for_chunk(self, prev_step: int, step: int, freq: int):
        """The window's rates when (prev_step, step] crosses a ``freq``
        boundary, else None without consuming the window; read once per
        chunk of steps, so that every boundary row of the chunk carries the
        same rates."""
        if step // freq == prev_step // freq:
            return None
        return self.window_stats()


def _process_index() -> int:
    """This process's ``torch.distributed`` rank, 0 when no process group
    is initialized (or torch is unusable). Looked up at each call, so that
    tests can monkeypatch it."""
    try:
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            return 0
        return dist.get_rank()
    except Exception:
        return 0


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
