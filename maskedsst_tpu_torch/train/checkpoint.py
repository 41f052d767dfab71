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

Every function here dispatches on the extension: a ``.msgpack`` path is
the JAX package's own checkpoint (full state, bare parameters, or a HyperX
net's parameters and BatchNorm statistics), read and written through
``io/flax_checkpoint.py`` with the same ``.json`` sidecar; ``.pth`` stays
the reference format (``io/torch_import.py``); anything else is a ``.pt``.

Under ``torch.distributed`` every process calls ``save_checkpoint`` at the
same points; only rank 0 writes, and a barrier follows, so that no rank
reads a file that is still being written. The state is replicated, so any
rank loads it, and a checkpoint written by W processes resumes under any
other number of them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


def save_checkpoint(path: str, state, config: Optional[Any] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a ``TrainState`` (or a bare ``state_dict``) and its sidecar, from
    rank 0 only; every rank waits at a barrier until the files are in place.
    A ``.msgpack`` path writes the JAX package's layout."""
    if is_flax(path):
        from maskedsst_tpu_torch.io.flax_checkpoint import write_flax_checkpoint

        write_flax_checkpoint(path, state, config, extra)
        return

    def write(tmp: str) -> None:
        torch.save(state.state_dict() if hasattr(state, "optimizer")
                   else {"params": dict(state)}, tmp)

    write_files(path, write, config, extra)


def write_files(path: str, write: Callable[[str], None], config, extra) -> None:
    """``write(staging path)`` the checkpoint, then its sidecar, each moved
    into place atomically, on rank 0 only; a barrier follows under
    ``torch.distributed``."""
    distributed = dist.is_available() and dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # atomic writes: best_*.pt is overwritten on every new best, and a
        # crash mid-write must not truncate the previous file; the staging
        # name is pid-unique, so two runs sharing a models dir never write
        # one file
        tmp = f"{path}.{os.getpid()}.tmp"
        write(tmp)
        os.replace(tmp, path)
        meta: Dict[str, Any] = {"extra": _jsonable(extra or {})}
        if config is not None:
            meta["config"] = _jsonable(config.to_dict() if hasattr(config, "to_dict") else config)
        tmp = f"{path}.json.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, default=str)
        os.replace(tmp, path + ".json")
    if distributed:
        dist.barrier()


def _load(path: str, device) -> Dict[str, Any]:
    return torch.load(path, map_location=device, weights_only=True)


def is_flax(path: str) -> bool:
    """A ``.msgpack`` path: the JAX package's checkpoint format."""
    return str(path).endswith(".msgpack")


def restore_checkpoint(path: str, state):
    """Restore a full-state checkpoint into the template ``state`` (its
    model and optimizer, built as the saving run built them), the tensors
    mapped onto the model's device. Returns ``state``. A ``.msgpack`` (the
    JAX trainers') restores parameters, Adam moments, step and rates
    exactly and seeds the generator from the file's JAX key
    (``io/flax_checkpoint.py``)."""
    if is_flax(path):
        from maskedsst_tpu_torch.io.flax_checkpoint import (
            read_flax_checkpoint,
            restore_flax_state,
        )

        restore_flax_state(read_flax_checkpoint(path), state)
        return state
    device = next(state.model.parameters()).device
    state.load_state_dict(_load(path, device))
    return state


def restore_params(path: str, device="cpu", model: Optional[torch.nn.Module] = None
                   ) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a full or bare checkpoint, on ``device``.
    A ``.msgpack`` maps through the converters of ``io/flax_params.py``:
    those of the DeepHyperX zoo when ``model`` is a zoo net (its BatchNorm
    statistics included where the file has them), else the ViTs'."""
    if is_flax(path):
        from maskedsst_tpu_torch.io.flax_checkpoint import (
            params_state_from_flax_checkpoint,
            read_flax_checkpoint,
        )

        state = params_state_from_flax_checkpoint(read_flax_checkpoint(path), model)
        return {k: v.to(device) for k, v in state.items()}
    payload = _load(path, device)
    return payload["model"] if "model" in payload else payload["params"]


def load_metadata(path: str) -> Dict[str, Any]:
    """The sidecar ``{"config", "extra"}``; a ``.msgpack``'s scheduler state
    comes back under the port's names (``scheduler_from_jax``)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if is_flax(path) and meta.get("extra", {}).get("scheduler"):
        from maskedsst_tpu_torch.io.flax_checkpoint import scheduler_from_jax

        meta["extra"]["scheduler"] = scheduler_from_jax(meta["extra"]["scheduler"])
    return meta


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
