"""The JAX package's ``.msgpack`` checkpoints, read into this package's
state and written from it (``io/flax_msgpack.py`` holds the format).

Layouts (``maskedsst_tpu/train/checkpoint.py``, ``hyperx/training.py``):

* a full train state ``{"step", "params", "opt_state", "rng"}``: ``step``
  an int32 scalar, ``rng`` a JAX key (uint32[2]);
* bare parameters ``{"params": tree}``, or the bare tree itself;
* a HyperX net ``{"params", "batch_stats"}``.

``params`` maps through ``io/flax_params.py`` (``params_from_flax``, or
``zoo_state_from_flax`` for a DeepHyperX net). The optimizer state is the
optax chain of the JAX trainers' recipes
(``maskedsst_tpu/train/optim.py::build_optimizer``):

* pretraining, ``flatten=True`` (``[clip,] inject_hyperparams(adamw)``):
  ``mu`` and ``nu`` are flat fp32 vectors over all parameters, in the
  sorted-key leaf order of the params tree (``jax.flatten_util.ravel_pytree``);
* finetuning, Adam with coupled L2 (``inject_hyperparams(chain(
  add_decayed_weights, scale_by_adam, scale_by_learning_rate))``), in
  ``multi_transform`` groups ``head`` / ``rest`` when the head's rate
  differs or under linear eval: each group's ``mu`` / ``nu`` is a params
  tree whose other group's leaves are empty dicts (optax's ``MaskedNode``);
  linear eval's ``rest`` holds no state.

* the DeepHyperX recipes (``inject_hyperparams(chain(add_decayed_weights,
  <optimizer>))``, hyperparameters ``learning_rate`` and ``wd``), in the
  same groups: SGD keeps optax ``trace`` (with momentum; none without),
  Adagrad ``sum_of_squares``, Adadelta ``e_g`` and ``e_x``.

optax's ``count`` is torch's per-parameter ``step`` where torch keeps one
(Adam, Adadelta), each group's ``hyperparams.learning_rate`` its ``lr``
(optax keeps it in float32, so a port rate written and read back is
rounded to float32), and the moments map by name:

==========  =======================  ===============================
optimizer   optax                    torch
==========  =======================  ===============================
Adam(W)     ``mu``, ``nu``           ``exp_avg``, ``exp_avg_sq``
SGD         ``trace``                ``momentum_buffer``
Adagrad     ``sum_of_squares``       ``sum`` (``train/optim.py``)
Adadelta    ``e_g``, ``e_x``         ``square_avg``, ``acc_delta``
==========  =======================  ===============================

A zoo net's trees go through ``zoo_state_from_flax`` /
``zoo_flax_from_state`` (its full state adds ``batch_stats`` where the net
has BatchNorm statistics).

A JAX key cannot become a torch generator's state: a resume seeds the
trainer's generator from the key's two words (the same file always gives
the same generator), so it continues the weights, moments, step, scheduler
and loop state exactly but draws crops, masks and dropout of its own. The
writer stores two words drawn from a copy of the generator.

Scheduler state in the sidecar: the JAX cosine scheduler's ``group_bases``
is the port's ``bases``; the plateau scheduler's ``best`` and
``num_bad_epochs`` are torch's (:func:`scheduler_from_jax`,
:func:`scheduler_to_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from maskedsst_tpu_torch.io.flax_msgpack import packb, unpackb
from maskedsst_tpu_torch.io.flax_params import (
    flax_from_params,
    flax_path,
    params_from_flax,
    zoo_flax_from_state,
    zoo_flax_skeleton,
    zoo_state_from_flax,
)

RECIPES = ("pretrain", "finetune")


def read_flax_checkpoint(path: str) -> Dict[str, Any]:
    """The tree of a ``.msgpack`` file (numpy leaves)."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def _is_zoo(model) -> bool:
    return model is not None and hasattr(model, "flax_conv_wrappers")


def params_state_from_flax_checkpoint(tree: Mapping[str, Any],
                                      model: Optional[torch.nn.Module] = None
                                      ) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` (CPU tensors) of a full-state, bare-params
    or HyperX tree. For a DeepHyperX ``model`` the variables go through
    ``zoo_state_from_flax`` (with the BatchNorm statistics when the file
    has them), else through ``params_from_flax``."""
    params = tree["params"] if "params" in tree else tree
    if _is_zoo(model):
        variables = {"params": params}
        if "batch_stats" in tree:
            variables["batch_stats"] = tree["batch_stats"]
        return zoo_state_from_flax(variables)
    return params_from_flax(params)


# --- the optimizer -----------------------------------------------------------

def _inject_states(node) -> List[Mapping[str, Any]]:
    """The ``inject_hyperparams`` states in the tree, in group order (head
    before rest, chain index order)."""
    if not isinstance(node, Mapping):
        return []
    if "hyperparams" in node and "inner_state" in node:
        return [node]
    return [s for key in sorted(node) for s in _inject_states(node[key])]


# torch state key ← optax moment key, per optimizer
MOMENTS = {
    "adam": {"exp_avg": "mu", "exp_avg_sq": "nu"},
    "sgd": {"momentum_buffer": "trace"},
    "adagrad": {"sum": "sum_of_squares"},
    "adadelta": {"square_avg": "e_g", "acc_delta": "e_x"},
}
# where torch keeps a per-parameter step
COUNTED = ("adam", "adadelta")


def _kind(optimizer: torch.optim.Optimizer) -> str:
    from maskedsst_tpu_torch.train.optim import Adagrad

    for cls, kind in ((torch.optim.Adam, "adam"), (torch.optim.AdamW, "adam"),
                      (torch.optim.SGD, "sgd"), (Adagrad, "adagrad"),
                      (torch.optim.Adadelta, "adadelta")):
        if type(optimizer) is cls:
            return kind
    raise NotImplementedError(
        f"the .msgpack optimizer state of a {type(optimizer).__name__} is not mapped: Adam, "
        "AdamW, SGD, Adagrad (train/optim.py) and Adadelta states are")


def _moment_state(inject: Mapping[str, Any], kind: str) -> Optional[Mapping[str, Any]]:
    """The optax state holding ``kind``'s moments in an inject state's
    chain (None for SGD without momentum, which keeps none)."""
    want = set(MOMENTS[kind].values())
    found = []

    def walk(node):
        if isinstance(node, Mapping):
            if want <= set(node):
                found.append(node)
            else:
                for v in node.values():
                    walk(v)

    walk(inject["inner_state"])
    if len(found) > 1 or (not found and kind != "sgd"):
        raise ValueError(f"the optax state holds {len(found)} {sorted(want)} states: not the "
                         f"{kind} recipe's chain")
    return found[0] if found else None


def _param_names(model: torch.nn.Module) -> Dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def _flat_order(model: torch.nn.Module) -> List[str]:
    """Parameter names in ``ravel_pytree``'s order: the flax paths sorted."""
    return sorted((n for n, _ in model.named_parameters()),
                  key=lambda n: flax_path(n, model.get_parameter(n).dim())[0])


def _unravel(flat, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A flat optax vector → one port-layout tensor per parameter."""
    flat = torch.as_tensor(np.asarray(flat))
    out, at = {}, 0
    for name in _flat_order(model):
        p = model.get_parameter(name)
        _, transposed = flax_path(name, p.dim())
        piece = flat[at:at + p.numel()]
        at += p.numel()
        out[name] = (piece.reshape(p.shape[::-1]).t() if transposed
                     else piece.reshape(p.shape)).contiguous()
    if at != flat.numel():
        raise ValueError(f"flat optimizer moments hold {flat.numel()} values, the model "
                         f"{at} parameters")
    return out


def _ravel(tensors: Mapping[str, torch.Tensor], model: torch.nn.Module) -> np.ndarray:
    parts = []
    for name in _flat_order(model):
        t = tensors[name].detach().cpu().float()
        _, transposed = flax_path(name, t.dim())
        parts.append((t.t() if transposed else t).reshape(-1))
    return torch.cat(parts).numpy()


def _tree_to_named(tree, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A params-shaped optax tree (``{}`` at another group's leaves) → port
    tensors by parameter name."""
    if _is_zoo(model):
        return zoo_state_from_flax({"params": tree})
    return params_from_flax(tree)


def optimizer_state_from_optax(tree: Mapping[str, Any], model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer,
                               recipe: Optional[str] = None) -> Dict[str, Any]:
    """The torch ``state_dict`` of ``optimizer`` (built over ``model`` as
    the trainer builds it) holding the optax state of the full-state
    ``tree``: moments, counts and each group's rate. ``recipe``:
    ``"pretrain"`` (flat moments) or ``"finetune"`` (moment trees); None
    tells them apart by the moments' form."""
    kind = _kind(optimizer)
    injects = _inject_states(tree["opt_state"])
    template = optimizer.state_dict()
    groups = optimizer.param_groups
    if len(injects) != len(groups):
        raise ValueError(f"the optax state has {len(injects)} optimized group(s), the "
                         f"optimizer {len(groups)}: build the trainer with the config that "
                         "wrote the checkpoint")
    first = _moment_state(injects[0], kind)
    flat = first is not None and isinstance(first[next(iter(MOMENTS[kind].values()))],
                                            (np.ndarray, torch.Tensor))
    if recipe is not None:
        if recipe not in RECIPES:
            raise ValueError(f"unknown recipe {recipe!r}: {RECIPES}")
        if flat != (recipe == "pretrain"):
            raise ValueError(f"the file's moments are {'flat' if flat else 'trees'}, which the "
                             f"{recipe} recipe does not write")
    names = _param_names(model)
    index = {id(p): i for i, p in enumerate(p for g in groups for p in g["params"])}
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    param_groups = []
    for inject, group, saved in zip(injects, groups, template["param_groups"]):
        held = _moment_state(inject, kind) or {}
        moments = {key: _unravel(held[okey], model) if flat else _tree_to_named(held[okey], model)
                   for key, okey in MOMENTS[kind].items() if okey in held}
        want = {names[id(p)] for p in group["params"]}
        for key, got in moments.items():
            if not flat and set(got) != want:
                raise ValueError(f"the optax group's {key} covers {sorted(set(got) ^ want)[:4]} "
                                 "unlike the optimizer's group")
        count = held["count"] if kind == "adam" else inject["count"]
        step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
        for p in group["params"]:
            name = names[id(p)]
            st = {key: got[name] for key, got in moments.items()}
            if kind in COUNTED:
                st["step"] = step.clone()
            if st:
                state[index[id(p)]] = st
        param_groups.append({**saved, "lr": float(np.asarray(inject["hyperparams"]
                                                             ["learning_rate"]))})
    return {"state": state, "param_groups": param_groups}


def generator_state_from_key(key) -> torch.Tensor:
    """The state of a CPU generator seeded from a JAX key's two words."""
    words = [int(w) for w in np.asarray(key, np.uint32).reshape(-1)[:2]]
    return torch.Generator().manual_seed((words[0] << 32) | words[1]).get_state()


def restore_flax_state(tree: Mapping[str, Any], state) -> None:
    """Load a full-state tree into a ``TrainState`` (its model and optimizer
    built as the writing run built them)."""
    for key in ("params", "opt_state", "step", "rng"):
        if key not in tree:
            raise ValueError(f"not a full-state checkpoint: no {key!r} (keys {sorted(tree)})")
    state.load_state_dict({
        "step": int(np.asarray(tree["step"])),
        "model": params_state_from_flax_checkpoint(tree, state.model),
        "optimizer": optimizer_state_from_optax(tree, state.model, state.optimizer),
        "rng": generator_state_from_key(tree["rng"]),
    })


# --- the sidecar's scheduler ---------------------------------------------------

def scheduler_from_jax(sched: Optional[Mapping[str, Any]]) -> Optional[Dict[str, Any]]:
    """A JAX scheduler state as the port's scheduler loads it: the cosine
    scheduler's ``group_bases`` is ``bases`` (None before its first epoch:
    the groups' rates stay the bases)."""
    if not sched or "group_bases" not in sched:
        return None if sched is None else dict(sched)
    out = {k: v for k, v in sched.items() if k != "group_bases"}
    out["bases"] = sched["group_bases"]
    return out


def scheduler_to_jax(sched: Optional[Mapping[str, Any]]) -> Optional[Dict[str, Any]]:
    """The port's scheduler state with the names the JAX schedulers read."""
    if not sched or "bases" not in sched:
        return None if sched is None else dict(sched)
    return {**sched, "group_bases": list(sched["bases"])}


# --- writing -------------------------------------------------------------------

def _chain(kind: str, held: Dict[str, Any], adamw: bool) -> Dict[str, Any]:
    """The recipe's chain state with the moments ``held`` at their link."""
    if kind == "adam":  # adamw: (scale_by_adam, decay, lr); Adam L2: (decay, adam, lr)
        chain = {str(i): {} for i in range(3)}
        chain["0" if adamw else "1"] = held
        return chain
    # chain(add_decayed_weights, <optax optimizer>), the latter a chain itself
    inner = {"sgd": {"0": held, "1": {}}, "adagrad": {"0": held, "1": {}},
             "adadelta": {"0": {}, "1": held, "2": {}}}[kind]
    return {"0": {}, "1": inner}


def _optax_group(kind: str, count: int, lr: float, wd: float, held: Dict[str, Any],
                 adamw: bool) -> Dict[str, Any]:
    """One ``inject_hyperparams`` state around the recipe's chain."""
    return {"count": np.asarray(count, np.int32),
            "hyperparams": {"learning_rate": np.asarray(lr, np.float32),
                            "weight_decay" if kind == "adam" else "wd":
                                np.asarray(wd, np.float32)},
            "hyperparams_states": {}, "inner_state": _chain(kind, held, adamw)}


def _moments(optimizer, p, key) -> torch.Tensor:
    st = optimizer.state.get(p, {})
    return st[key] if key in st else torch.zeros_like(p, dtype=torch.float32)


def _masked(full: Mapping[str, Any], mine: Mapping[str, Any]) -> Dict[str, Any]:
    """``full``'s nesting with ``mine``'s leaves, ``{}`` (optax's MaskedNode)
    where ``mine`` has none."""
    return {k: (_masked(v, mine.get(k, {})) if isinstance(v, Mapping) else mine.get(k, {}))
            for k, v in full.items()}


def optax_from_optimizer(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         recipe: str, clip: bool = True, step: int = 0) -> Dict[str, Any]:
    """The optax state (as flax serializes it) of a port optimizer: the
    inverse of :func:`optimizer_state_from_optax`. ``clip``: the pretraining
    chain starts with ``optax.clip`` (``clip_grad_norm``); ``step``: the
    count of an optimizer that keeps none (SGD, Adagrad)."""
    kind = _kind(optimizer)
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}: {RECIPES}")
    adamw = isinstance(optimizer, torch.optim.AdamW)
    keys = MOMENTS[kind]
    if kind == "sgd" and not all(g["momentum"] for g in optimizer.param_groups):
        keys = {}  # optax sgd without momentum keeps no trace

    def count_of(group) -> int:
        if kind not in COUNTED:
            return step
        steps = [optimizer.state[p]["step"] for p in group["params"] if p in optimizer.state]
        return int(steps[0]) if steps else 0

    if recipe == "pretrain":
        if kind != "adam":
            raise NotImplementedError(f"the pretraining recipe's flat state of a {kind} "
                                      "optimizer is not mapped")
        (group,) = optimizer.param_groups
        n = count_of(group)
        params = dict(model.named_parameters())
        held = {"count": np.asarray(n, np.int32),
                **{okey: _ravel({k: _moments(optimizer, p, key) for k, p in params.items()},
                                model) for key, okey in keys.items()}}
        inject = _optax_group(kind, n, group["lr"], group["weight_decay"], held, adamw)
        return {"0": {}, "1": inject} if clip else inject

    def tree_of(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        if _is_zoo(model):
            return zoo_flax_from_state(named, zoo_flax_skeleton(model))["params"]
        return flax_from_params(named)

    named = list(model.named_parameters())
    full = tree_of({n: p for n, p in named})
    injects = []
    for group in optimizer.param_groups:
        n = count_of(group)
        mine = {id(p) for p in group["params"]}
        held = {okey: _masked(full, tree_of({k: _moments(optimizer, p, key) for k, p in named
                                             if id(p) in mine}))
                for key, okey in keys.items()}
        if kind == "adam":
            held = {"count": np.asarray(n, np.int32), **held}
        injects.append(_optax_group(kind, n, group["lr"], group["weight_decay"], held, adamw))
    groups = optimizer.param_groups
    if len(groups) == 1 and all(id(p) in {id(q) for q in groups[0]["params"]}
                                for p in model.parameters()):
        return injects[0]  # no groups: one inject state over the whole tree
    inner = {"head": {"inner_state": injects[0]}}
    inner["rest"] = {"inner_state": injects[1] if len(injects) > 1 else {}}
    return {"inner_states": inner}


def _key_words(rng: torch.Generator) -> np.ndarray:
    """Two uint32 words drawn from a copy of ``rng`` (``rng`` itself is not
    advanced)."""
    copy = torch.Generator()
    copy.set_state(rng.get_state())
    return torch.randint(0, 2**32, (2,), generator=copy, dtype=torch.int64).numpy().astype(
        np.uint32)


def flax_tree_of(state_or_params, config: Optional[Any] = None) -> Dict[str, Any]:
    """The tree ``write_flax_checkpoint`` writes (see there)."""
    from maskedsst_tpu_torch.models import SimMIM, SimMIMSpatialSpectral

    if hasattr(state_or_params, "optimizer"):
        state = state_or_params
        model = state.model
        recipe = "pretrain" if isinstance(model, (SimMIM, SimMIMSpatialSpectral)) else "finetune"
        clip = bool(config.get("clip_grad_norm")) if config is not None else True
        variables = (zoo_flax_from_state(model.state_dict(), zoo_flax_skeleton(model))
                     if _is_zoo(model) else {"params": flax_from_params(model.state_dict())})
        return {"step": np.asarray(state.step, np.int32), **variables,
                "opt_state": optax_from_optimizer(model, state.optimizer, recipe, clip,
                                                  state.step),
                "rng": _key_words(state.rng)}
    if isinstance(state_or_params, torch.nn.Module):
        model = state_or_params
        if _is_zoo(model):
            return zoo_flax_from_state(model.state_dict(), zoo_flax_skeleton(model))
        return {"params": flax_from_params(model.state_dict())}
    return {"params": flax_from_params(state_or_params)}


def write_flax_checkpoint(path: str, state_or_params, config: Optional[Any] = None,
                          extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state_or_params`` as the JAX package writes it, with its
    ``.json`` sidecar ``{"config", "extra"}``, both atomically; under
    ``torch.distributed`` rank 0 writes and every rank waits at a barrier
    (``train/checkpoint.py::write_files``).

    ``state_or_params``: a ``TrainState`` (the full state: the pretraining
    recipe's layout for a SimMIM model, its clip from
    ``config.clip_grad_norm``, present without a config; else the
    finetuning recipe's, a zoo net's with its ``batch_stats`` where it has
    BatchNorm statistics), a model (a zoo net as ``{"params",
    "batch_stats"}``, the HyperX layout; any other as ``{"params"}``) or a
    ``state_dict`` (``{"params"}``)."""
    from maskedsst_tpu_torch.train.checkpoint import write_files

    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(packb(flax_tree_of(state_or_params, config)))

    extra = dict(extra or {})
    if "scheduler" in extra:
        extra["scheduler"] = scheduler_to_jax(extra["scheduler"])
    write_files(path, write, config, extra)
