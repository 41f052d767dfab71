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

optax's ``count`` is torch's per-parameter ``step``, ``mu`` ``exp_avg``,
``nu`` ``exp_avg_sq``, each group's ``hyperparams.learning_rate`` its
``lr`` (optax keeps it in float32, so a port rate written and read back
is rounded to float32). The zoo's other optimizers (SGD, Adagrad, Adadelta) are not mapped
and raise ``NotImplementedError``.

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


def _adam_state(inject: Mapping[str, Any]) -> Mapping[str, Any]:
    inner = inject["inner_state"]
    found = [v for v in (inner.values() if isinstance(inner, Mapping) else ())
             if isinstance(v, Mapping) and {"count", "mu", "nu"} <= set(v)]
    if len(found) != 1:
        raise NotImplementedError(
            "the optax state holds no Adam moments (mu, nu): only the Adam and AdamW recipes' "
            "states map onto torch's")
    return found[0]


def _check_adam(optimizer: torch.optim.Optimizer) -> None:
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise NotImplementedError(
            f"the .msgpack optimizer state of a {type(optimizer).__name__} is not mapped: only "
            "Adam (finetuning) and AdamW (pretraining) states are (ROADMAP.md)")


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


def optimizer_state_from_optax(tree: Mapping[str, Any], model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer,
                               recipe: Optional[str] = None) -> Dict[str, Any]:
    """The torch ``state_dict`` of ``optimizer`` (built over ``model`` as
    the trainer builds it) holding the optax state of the full-state
    ``tree``: moments, counts and each group's rate. ``recipe``:
    ``"pretrain"`` (flat moments) or ``"finetune"`` (moment trees); None
    tells them apart by the moments' form."""
    _check_adam(optimizer)
    injects = _inject_states(tree["opt_state"])
    template = optimizer.state_dict()
    groups = optimizer.param_groups
    if len(injects) != len(groups):
        raise ValueError(f"the optax state has {len(injects)} optimized group(s), the "
                         f"optimizer {len(groups)}: build the trainer with the config that "
                         "wrote the checkpoint")
    flat = isinstance(_adam_state(injects[0])["mu"], (np.ndarray, torch.Tensor))
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
        adam = _adam_state(inject)
        if flat:
            mu, nu = _unravel(adam["mu"], model), _unravel(adam["nu"], model)
        else:
            mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
        want = {names[id(p)] for p in group["params"]}
        if not flat and set(mu) != want:
            raise ValueError(f"the optax group's moments cover {sorted(set(mu) ^ want)[:4]} "
                             "unlike the optimizer's group")
        step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
        for p in group["params"]:
            name = names[id(p)]
            state[index[id(p)]] = {"step": step.clone(), "exp_avg": mu[name],
                                   "exp_avg_sq": nu[name]}
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

def _optax_group(inject_count: int, lr: float, wd: float, adam: Dict[str, Any],
                 adam_at: int) -> Dict[str, Any]:
    """One ``inject_hyperparams`` state around a three-link chain with the
    Adam moments at ``adam_at``."""
    chain = {str(i): {} for i in range(3)}
    chain[str(adam_at)] = adam
    return {"count": np.asarray(inject_count, np.int32),
            "hyperparams": {"learning_rate": np.asarray(lr, np.float32),
                            "weight_decay": np.asarray(wd, np.float32)},
            "hyperparams_states": {}, "inner_state": chain}


def _moments(optimizer, p, key) -> torch.Tensor:
    st = optimizer.state.get(p, {})
    return st[key] if key in st else torch.zeros_like(p, dtype=torch.float32)


def optax_from_optimizer(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         recipe: str, clip: bool = True) -> Dict[str, Any]:
    """The optax state (as flax serializes it) of a port optimizer: the
    inverse of :func:`optimizer_state_from_optax`. ``clip``: the pretraining
    chain starts with ``optax.clip`` (``clip_grad_norm``)."""
    _check_adam(optimizer)
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}: {RECIPES}")
    adam_at = 0 if isinstance(optimizer, torch.optim.AdamW) else 1

    def count_of(group) -> int:
        steps = [optimizer.state[p]["step"] for p in group["params"] if p in optimizer.state]
        return int(steps[0]) if steps else 0

    if recipe == "pretrain":
        (group,) = optimizer.param_groups
        n = count_of(group)
        params = dict(model.named_parameters())
        adam = {"count": np.asarray(n, np.int32),
                "mu": _ravel({k: _moments(optimizer, p, "exp_avg") for k, p in params.items()},
                             model),
                "nu": _ravel({k: _moments(optimizer, p, "exp_avg_sq")
                              for k, p in params.items()}, model)}
        inject = _optax_group(n, group["lr"], group["weight_decay"], adam, adam_at)
        return {"0": {}, "1": inject} if clip else inject

    def masked_tree(group, key):
        """The params tree with this group's moments, the other leaves {}
        (optax's MaskedNode)."""
        mine = {id(p) for p in group["params"]}
        named = list(model.named_parameters())
        tree = flax_from_params({n: _moments(optimizer, p, key) for n, p in named
                                 if id(p) in mine})
        for n, p in named:
            if id(p) not in mine:
                path, _ = flax_path(n, p.dim())
                node = tree
                for part in path[:-1]:
                    node = node.setdefault(part, {})
                node[path[-1]] = {}
        return tree

    groups = optimizer.param_groups
    injects = []
    for group in groups:
        n = count_of(group)
        adam = {"count": np.asarray(n, np.int32), "mu": masked_tree(group, "exp_avg"),
                "nu": masked_tree(group, "exp_avg_sq")}
        injects.append(_optax_group(n, group["lr"], group["weight_decay"], adam, adam_at))
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
        if _is_zoo(model):
            raise NotImplementedError("a zoo net's full train state is not written as .msgpack "
                                      "(its optimizer's state is not mapped)")
        recipe = "pretrain" if isinstance(model, (SimMIM, SimMIMSpatialSpectral)) else "finetune"
        clip = bool(config.get("clip_grad_norm")) if config is not None else True
        return {"step": np.asarray(state.step, np.int32),
                "params": flax_from_params(model.state_dict()),
                "opt_state": optax_from_optimizer(model, state.optimizer, recipe, clip),
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
    finetuning recipe's), a model (a zoo net as ``{"params",
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
