"""Full-state checkpoints, the JAX package's ``train/checkpoint.py``.

A checkpoint is one ``torch.save`` payload ``{"step", "model" (the
model's ``state_dict``), "optimizer" (its ``state_dict``), "rng" (the
trainer's generator state)}`` (a bare ``state_dict`` is saved as
``{"params": ...}``), and beside it ``path + ".json"``, a sidecar
``{"config", "extra"}`` that carries the scheduler and the loop state a
resume needs. Both files are written atomically. The layout mirrors the
JAX package's, with ``.pt`` in place of ``.msgpack``:

  models/{run_id}/model_{encoder_name}_ep{N}.pt          (pretraining)
  models/{run_id}/model_{encoder_name}_at_step{S}.pt     (pretraining, step budget)
  models/{run_id}/{method}_at_ep{N}.pt                   (finetuning)
  models/{run_id}/best_{method}.pt                       (finetuning, best val acc)
  models/{run_id}/{method}_at_step{S}.pt                 (finetuning, budget end)

``.pth`` stays the reference format (``io/torch_import.py``).

Under ``torch.distributed`` every process calls ``save_checkpoint`` at the
same points; only rank 0 writes, and a barrier follows, so that no rank
reads a file that is still being written. The state is replicated, so any
rank loads it, and a checkpoint written by W processes resumes under any
other number of them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


def save_checkpoint(path: str, state, config: Optional[Any] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a ``TrainState`` (or a bare ``state_dict``) and its sidecar, from
    rank 0 only; every rank waits at a barrier until the files are in place."""
    distributed = dist.is_available() and dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        _write(path, state, config, extra)
    if distributed:
        dist.barrier()


def _write(path: str, state, config, extra) -> None:
    payload = state.state_dict() if hasattr(state, "optimizer") else {"params": dict(state)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic writes: best_*.pt is overwritten on every new best, and a crash
    # mid-write must not truncate the previous file; the staging name is
    # pid-unique, so two runs sharing a models dir never write one file
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta: Dict[str, Any] = {"extra": _jsonable(extra or {})}
    if config is not None:
        meta["config"] = _jsonable(config.to_dict() if hasattr(config, "to_dict") else config)
    tmp = f"{path}.json.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, default=str)
    os.replace(tmp, path + ".json")


def _load(path: str, device) -> Dict[str, Any]:
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(path: str, state):
    """Restore a full-state checkpoint into the template ``state`` (its
    model and optimizer, built as the saving run built them), the tensors
    mapped onto the model's device. Returns ``state``."""
    device = next(state.model.parameters()).device
    state.load_state_dict(_load(path, device))
    return state


def restore_params(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a full or bare checkpoint, on ``device``."""
    payload = _load(path, device)
    return payload["model"] if "model" in payload else payload["params"]


def load_metadata(path: str) -> Dict[str, Any]:
    with open(path + ".json") as f:
        return json.load(f)


def _jsonable(obj):
    if isinstance(obj, Mapping):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return np.asarray(obj.cpu() if isinstance(obj, torch.Tensor) else obj).tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj
