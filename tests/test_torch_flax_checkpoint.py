"""The JAX package's ``.msgpack`` checkpoints in the port, on the CPU.

* ``io/flax_msgpack.py`` against flax: ``unpackb`` of ``to_bytes`` equals
  ``msgpack_restore`` leaf for leaf and bit for bit, ``packb`` writes the
  bytes ``to_bytes`` writes (chunked arrays included, with flax's
  ``MAX_CHUNK_SIZE`` made small).
* Both recipes' optax chains (``maskedsst_tpu/train/optim.py``) applied
  eagerly for two updates to seeded gradients over the port model's
  weights, saved by ``maskedsst_tpu/train/checkpoint.py::save_checkpoint``:
  the port's ``resume`` gives the optax moments, counts and rates bit for
  bit, and one more update on the same gradient stays within 1e-6 of
  max|param| and 1e-2·lr of optax's. What the port writes, the JAX package
  restores into its own template.
* ``load_pretrained_params`` on a JAX-written ``.msgpack`` against the JAX
  loader; a HyperX BatchNorm net saved by the JAX trainer against its JAX
  eval logits (3e-5; the semi nets 5e-4).

Narrow geometry (40 bands, dim 24, depth 1); the JAX side runs optax and
flax eagerly on numpy trees, plus one small model init in the JAX loader.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from maskedsst_tpu.config import get_finetune_config as jax_finetune_config
from maskedsst_tpu.hyperx.training import HyperXTrainer as JaxHyperXTrainer
from maskedsst_tpu.models.zoo import get_model as jax_get_model
from maskedsst_tpu.train import checkpoint as jax_checkpoint
from maskedsst_tpu.train.factory import build_finetune_model as jax_build_finetune
from maskedsst_tpu.train.factory import load_pretrained_params as jax_load_pretrained
from maskedsst_tpu.train.finetuner import make_head_label_fn as jax_head_label_fn
from maskedsst_tpu.train.optim import build_optimizer as jax_optimizer
from maskedsst_tpu.train.train_state import TrainState as JaxTrainState
from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
from maskedsst_tpu_torch.hyperx.inference import predict_scene
from maskedsst_tpu_torch.hyperx.training import HyperXTrainer
from maskedsst_tpu_torch.io import flax_checkpoint, flax_msgpack
from maskedsst_tpu_torch.io.flax_params import flax_from_params, params_from_flax
from maskedsst_tpu_torch.models.zoo import get_model
from maskedsst_tpu_torch.train.checkpoint import load_metadata, save_checkpoint
from maskedsst_tpu_torch.train.factory import build_finetune_model, load_pretrained_params
from maskedsst_tpu_torch.train.finetuner import Finetuner
from maskedsst_tpu_torch.train.optim import CosineAnnealingLR, clamp_gradients_
from maskedsst_tpu_torch.tools.export_torch_checkpoint import export_checkpoint
from maskedsst_tpu_torch.train.pretrainer import Pretrainer

NARROW = dict(n_bands=40, transformer_dim=24, transformer_depth=1, transformer_n_heads=2,
              transformer_mlp_dim=32)
CONFIGS = ("configs/config.yaml",)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bf16 tensors and numpy arrays alike)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _assert_same_tree(got, want, ordered=True):
    """Equal trees, leaf for leaf and bit for bit (keys in the same order
    unless ``ordered`` is false)."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert list(got) == list(want) if ordered else sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k], ordered)
        return
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) or isinstance(got, torch.Tensor), (type(got), type(want))
        g, w = _bits(got), _bits(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    else:
        assert type(got) is type(want) and got == want


# --- the format ----------------------------------------------------------------

def _sample_tree(rng):
    return {
        "params": {"Dense_0": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                               "bias": np.zeros(5, np.float32)},
                   "empty": {}},
        "bf16": np.asarray(rng.standard_normal((4, 2)), jnp.bfloat16),
        "int32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
        "key": np.asarray([7, 2**32 - 1], np.uint32),
        "scalar0d": np.asarray(3, np.int32),
        "npscalar": np.float32(0.25),
        "py": {"int": 5, "neg": -40, "u16": 60000, "i64": -2**40, "f": 1.5, "t": True,
               "none": None, "s": "x" * 40, "c": 1 - 2j},
        "list": [1, 2.0, "three"],
        "zero_size": np.zeros((0, 3), np.float64),
    }


def test_unpackb_equals_msgpack_restore_bit_for_bit():
    rng = np.random.default_rng(0)
    tree = _sample_tree(rng)
    for k in range(20):  # a map16
        tree[f"k{k}"] = np.full(300, k, np.int16)  # ext 16 payloads
    data = serialization.to_bytes(tree)
    got = flax_msgpack.unpackb(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    assert got["bf16"].dtype == torch.bfloat16
    assert isinstance(got["npscalar"], np.float32) and got["py"]["c"] == 1 - 2j


def test_packb_writes_to_bytes_byte_for_byte():
    rng = np.random.default_rng(1)
    tree = _sample_tree(rng)
    mine = dict(tree, bf16=torch.from_numpy(tree["bf16"].view(np.int16).copy()).view(
        torch.bfloat16))
    assert flax_msgpack.packb(mine) == serialization.to_bytes(tree)
    assert flax_msgpack.packb(tree["params"]) == serialization.to_bytes(tree["params"])


def test_chunked_arrays_round_trip(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes are split (flax's ``_chunk``) and
    put back together, bf16 ones too."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((10, 7)).astype(np.float32), "small": np.arange(3),
            "bf": np.asarray(rng.standard_normal(100), jnp.bfloat16)}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.unpackb(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    mine = dict(tree, bf=torch.from_numpy(tree["bf"].view(np.int16).copy()).view(torch.bfloat16))
    assert flax_msgpack.packb(mine) == data


def test_unknown_types_raise_naming_them():
    with pytest.raises(ValueError, match="ext type code 5"):
        flax_msgpack.unpackb(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="map key of type int"):
        flax_msgpack.unpackb(b"\x81\x01\x02")
    with pytest.raises(ValueError, match="reserved type byte 0xc1"):
        flax_msgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="float8"):
        flax_msgpack.unpackb(flax_msgpack.packb(np.zeros(2, np.float32)).replace(
            b"\xa7float32", b"\xa7float8_"))
    with pytest.raises(ValueError, match="map key of type int"):
        flax_msgpack.packb({1: 2})


# --- the trainers' full states -----------------------------------------------------

def _pretrain_cfg():
    cfg = get_pretrain_config("configs/pretrain_config.yaml", *CONFIGS)
    for key, value in {**NARROW, "batch_size": 4}.items():
        setattr(cfg, key, value)
    return cfg


def _finetune_cfg(case):
    cfg = get_finetune_config("configs/finetune_config_enmap.yaml", *CONFIGS)
    for key, value in {**NARROW, "batch_size": 4, "spectral_pos": cfg.spectral_pos[:4]}.items():
        setattr(cfg, key, value)
    if case == "one_group":
        cfg.mlp_head_lr = cfg.lr
    elif case == "linear_eval":
        cfg.linear_eval = True
    return cfg


def _grads(params, seed):
    """Seeded gradients over a flax tree, a few beyond the [-1, 1] clamp."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.6).astype(np.float32), params)


def _jax_run(params, tx, grads, steps):
    """optax applied eagerly: (params, opt_state) after ``steps`` updates."""
    opt_state = tx.init(params)
    for _ in range(steps):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state


def _jax_save(path, params, opt_state, steps, extra, config):
    state = types.SimpleNamespace(step=jnp.asarray(steps, jnp.int32), params=params,
                                  opt_state=opt_state, rng=jax.random.PRNGKey(11))
    jax_checkpoint.save_checkpoint(str(path), state, config.to_dict(), extra=extra)


def _port_step(trainer, grads, clamp):
    """One optimizer update of the port from flax-tree gradients."""
    g = params_from_flax(grads)
    for name, p in trainer.model.named_parameters():
        p.grad = g[name].clone()
    if clamp:
        clamp_gradients_(trainer.model.parameters(), 1.0)
    trainer.state.apply_gradients()


def _check_next_update(trainer, params, grads, tx, opt_state, lr, clamp):
    _port_step(trainer, grads, clamp)
    updates, _ = tx.update(grads, opt_state, params)
    want = params_from_flax(optax.apply_updates(params, updates))
    for name, p in trainer.model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        scale = float(want[name].abs().max())
        assert err <= 1e-6 * max(scale, 1.0) and err <= 1e-2 * lr, (name, err, scale)


def _adam_leaves(opt_state):
    """[(count, mu, nu, learning rate)] per optax group, head before rest."""
    tree = serialization.msgpack_restore(serialization.to_bytes(opt_state))
    injects = flax_checkpoint._inject_states(tree)
    out = []
    for inject in injects:
        adam = flax_checkpoint._adam_state(inject)
        out.append((adam["count"], adam["mu"], adam["nu"],
                    inject["hyperparams"]["learning_rate"]))
    return out


def test_pretraining_resume_from_a_jax_msgpack(tmp_path):
    """AdamW + clip + flat moments (pretrainer.py:132-137): the flat mu / nu
    unravel in the params tree's sorted leaf order onto exp_avg /
    exp_avg_sq bit for bit; count, rate, weights, the plateau scheduler."""
    cfg = _pretrain_cfg()
    trainer = Pretrainer(cfg, tile_size=32, device="cpu")
    params = flax_from_params(trainer.model.state_dict())
    tx = jax_optimizer("AdamW", cfg.lr, cfg.weight_decay, grad_clamp=1.0, flatten=True)
    grads = _grads(params, 3)
    jparams, opt_state = _jax_run(params, tx, grads, 2)
    path = tmp_path / "model_pre_at_step2.msgpack"
    sched = {"best": 0.25, "num_bad_epochs": 3}
    _jax_save(path, jparams, opt_state, 2, {"epoch": 0, "scheduler": sched}, cfg)

    assert trainer.resume(str(path)) == 2
    assert trainer.scheduler.best == 0.25 and trainer.scheduler.num_bad_epochs == 3
    ((count, mu, nu, lr),) = _adam_leaves(opt_state)
    unravel = ravel_pytree(params)[1]  # JAX's own unravelling of the flat vectors
    mu, nu = params_from_flax(unravel(mu)), params_from_flax(unravel(nu))
    want_params = params_from_flax(jparams)
    for name, p in trainer.model.named_parameters():
        st = trainer.state.optimizer.state[p]
        assert torch.equal(p.detach(), want_params[name]), name
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == int(count) == 2
    assert trainer.state.optimizer.param_groups[0]["lr"] == float(lr)
    # the generator: seeded from the key's words, the same on every resume
    again = Pretrainer(cfg, tile_size=32, device="cpu")
    again.resume(str(path))
    assert torch.equal(again.state.rng.get_state(), trainer.state.rng.get_state())
    assert not torch.equal(again.state.rng.get_state(),
                           Pretrainer(cfg, tile_size=32, device="cpu").state.rng.get_state())
    tree = flax_checkpoint.read_flax_checkpoint(str(path))
    with pytest.raises(ValueError, match="flat"):  # the finetuning recipe writes trees
        flax_checkpoint.optimizer_state_from_optax(tree, trainer.model, trainer.state.optimizer,
                                                   "finetune")
    _check_next_update(trainer, jparams, grads, tx, opt_state, cfg.lr, clamp=True)


@pytest.mark.parametrize("case", ["groups", "one_group", "linear_eval"])
def test_finetuning_resume_from_a_jax_msgpack(tmp_path, case):
    """Adam with coupled L2 in head / rest groups (the MaskedNode leaves of
    each group's moment tree skipped), in one group, and under linear
    eval; the sidecar's loop state."""
    cfg = _finetune_cfg(case)
    model, kw = build_finetune_model(cfg, device="cpu")
    trainer = Finetuner(cfg, model, tile_size=32, **kw)
    params = flax_from_params(model.state_dict())
    head_lr = None if cfg.linear_eval else cfg.mlp_head_lr
    tx = jax_optimizer("Adam", cfg.lr, cfg.weight_decay, head_lr=head_lr,
                       head_label_fn=jax_head_label_fn(None), linear_eval=cfg.linear_eval)
    grads = _grads(params, 4)
    jparams, opt_state = _jax_run(params, tx, grads, 2)
    path = tmp_path / "best_ViTSpatialSpectral.msgpack"
    extra = {"epoch": 1, "step": 2, "best_val_acc": 0.5, "last_val_loss": 1.25,
             "scheduler": {"best": 1.0, "num_bad_epochs": 1}}
    _jax_save(path, jparams, opt_state, 2, extra, cfg)

    assert trainer.resume(str(path)) == 2
    assert trainer._resume_extra["best_val_acc"] == 0.5
    assert trainer.scheduler.num_bad_epochs == 1
    groups = trainer.state.optimizer.param_groups
    want = _adam_leaves(opt_state)
    assert len(groups) == len(want) == {"groups": 2, "one_group": 1, "linear_eval": 1}[case]
    names = {id(p): n for n, p in model.named_parameters()}
    want_params = params_from_flax(jparams)
    for group, (count, mu, nu, lr) in zip(groups, want):
        assert group["lr"] == float(lr)
        mu, nu = params_from_flax(mu), params_from_flax(nu)
        assert set(mu) == {names[id(p)] for p in group["params"]}
        for p in group["params"]:
            st = trainer.state.optimizer.state[p]
            assert torch.equal(st["exp_avg"], mu[names[id(p)]])
            assert torch.equal(st["exp_avg_sq"], nu[names[id(p)]])
            assert float(st["step"]) == int(count) == 2
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want_params[name]), name
    if case == "linear_eval":  # the frozen backbone is left out of the optimizer
        grads = jax.tree_util.tree_map_with_path(
            lambda path, g: g if jax_head_label_fn(None)(tuple(k.key for k in path)) else g * 0,
            grads)
    _check_next_update(trainer, jparams, grads, tx, opt_state, cfg.lr, clamp=False)


@pytest.mark.parametrize("recipe", ["pretrain", "finetune"])
def test_the_jax_package_restores_what_the_port_writes(tmp_path, recipe):
    """write_flax_checkpoint after two port updates: the JAX package's
    ``restore_checkpoint`` takes the file into its own TrainState template
    (the trees match key for key), every leaf equal to the port's state,
    and the port's resume from it gives the same state back bit for bit."""
    if recipe == "pretrain":
        cfg = _pretrain_cfg()
        trainer = Pretrainer(cfg, tile_size=32, device="cpu")
        tx = jax_optimizer("AdamW", cfg.lr, cfg.weight_decay, grad_clamp=1.0, flatten=True)
        clamp = True
    else:
        cfg = _finetune_cfg("groups")
        model, kw = build_finetune_model(cfg, device="cpu")
        trainer = Finetuner(cfg, model, tile_size=32, **kw)
        tx = jax_optimizer("Adam", cfg.lr, cfg.weight_decay, head_lr=cfg.mlp_head_lr,
                           head_label_fn=jax_head_label_fn(None))
        clamp = False
    params = flax_from_params(trainer.model.state_dict())
    grads = _grads(params, 5)
    for _ in range(2):
        _port_step(trainer, grads, clamp)
    path = tmp_path / "port.msgpack"
    save_checkpoint(str(path), trainer.state, cfg, extra={"scheduler": {"epoch": 2,
                                                                        "bases": [1e-3]}})
    template = JaxTrainState.create(params, tx, jax.random.PRNGKey(0))
    restored = jax_checkpoint.restore_checkpoint(str(path), template)
    assert int(restored.step) == 2
    written = flax_checkpoint.read_flax_checkpoint(str(path))
    _assert_same_tree(
        flax_msgpack.unpackb(serialization.to_bytes(
            {"step": restored.step, "params": restored.params,
             "opt_state": restored.opt_state, "rng": restored.rng})),
        {k: written[k] for k in ("step", "params", "opt_state", "rng")}, ordered=False)
    for name, p in trainer.model.named_parameters():
        assert torch.equal(params_from_flax(restored.params)[name], p.detach())
    sidecar = json.loads((tmp_path / "port.msgpack.json").read_text())
    assert sidecar["extra"]["scheduler"]["group_bases"] == [1e-3]
    assert load_metadata(str(path))["extra"]["scheduler"]["bases"] == [1e-3]

    if recipe == "pretrain":
        back = Pretrainer(cfg, tile_size=32, device="cpu")
    else:
        model, kw = build_finetune_model(cfg, device="cpu")
        back = Finetuner(cfg, model, tile_size=32, **kw)
    back.resume(str(path))
    a, b = trainer.state, back.state
    assert a.step == b.step
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key], b.optimizer.state[q][key]), (name, key)
    # optax keeps a rate in float32: the round trip rounds it there
    assert [float(np.float32(g["lr"])) for g in a.optimizer.param_groups] == \
        [g["lr"] for g in b.optimizer.param_groups]


def test_cosine_scheduler_state_maps_group_bases(tmp_path):
    """The JAX cosine scheduler's ``group_bases`` loads as the port's
    ``bases``; None (before its first epoch) keeps the groups' rates."""
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    sched = CosineAnnealingLR(opt, t_max=50)
    path = str(tmp_path / "c.msgpack")
    for bases, want in (([0.5], [0.5]), (None, [0.1])):
        with open(path, "wb") as f:
            f.write(serialization.to_bytes({"params": {}}))
        with open(path + ".json", "w") as f:
            json.dump({"extra": {"scheduler": {"epoch": 7, "group_bases": bases}}}, f)
        sched.bases = [0.1]
        sched.load_state_dict(load_metadata(path)["extra"]["scheduler"])
        assert sched.epoch == 7 and sched.bases == want


def test_zoo_optimizer_states_are_not_mapped(tmp_path):
    cfg = _pretrain_cfg()
    trainer = Pretrainer(cfg, tile_size=32, device="cpu")
    trainer.state.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=0.1)
    with pytest.raises(NotImplementedError, match="SGD"):
        flax_checkpoint.optimizer_state_from_optax({"opt_state": {}}, trainer.model,
                                                   trainer.state.optimizer)


# --- pretrained encoders and the HyperX nets -------------------------------------

def _jax_ft_config(patch_sub):
    jcfg = jax_finetune_config("configs/finetune_config_enmap.yaml", *CONFIGS)
    for key, value in {**NARROW, "spectral_pos": jcfg.spectral_pos[:4],
                       "patch_sub": patch_sub}.items():
        setattr(jcfg, key, value)
    return jcfg


def test_load_pretrained_params_matches_the_jax_loader(tmp_path):
    """A JAX pretraining full state and a JAX classifier's bare params, each
    loaded into a finetune model with ``patch_sub`` 2 (pos_embed truncated
    to 6x6): every entry the checkpoint gives equals the JAX loader's
    through params_from_flax, the rest is the port's seeded init; a
    checkpoint with too few positions fails the reference's assertion."""
    pre = Pretrainer(_pretrain_cfg(), tile_size=32, device="cpu")
    pre_path = tmp_path / "pre.msgpack"
    params = flax_from_params(pre.model.state_dict())
    tx = jax_optimizer("AdamW", 1e-3, 0.05, grad_clamp=1.0, flatten=True)
    jparams, opt_state = _jax_run(params, tx, _grads(params, 6), 1)
    _jax_save(pre_path, jparams, opt_state, 1, {}, pre.config)
    cls_cfg = _finetune_cfg("groups")
    classifier, _ = build_finetune_model(cls_cfg, device="cpu")
    bare_path = tmp_path / "bare.msgpack"
    jax_checkpoint.save_checkpoint(str(bare_path), flax_from_params(classifier.state_dict()))

    cfg = _finetune_cfg("groups")
    cfg.patch_sub = 2
    model, _ = build_finetune_model(cfg, device="cpu")
    jcfg = _jax_ft_config(2)
    jmodel, _ = jax_build_finetune(jcfg)
    fresh = model.init_weights(5).state_dict()
    for path in (pre_path, bare_path):
        got = load_pretrained_params(str(path), cfg, model, seed=5)
        want = params_from_flax(jax_load_pretrained(str(path), jcfg, jmodel, seed=5))
        raw = flax_checkpoint.read_flax_checkpoint(str(path))["params"]
        carried = {k for k in params_from_flax(raw.get("encoder", raw))
                   if k in got and not k.startswith("head_linear.")}
        assert "pos_embed" in carried or path == pre_path
        assert carried and got.keys() == fresh.keys()
        for key in got:
            assert torch.equal(got[key], want[key] if key in carried else fresh[key]), key
        if path == bare_path:
            assert got["pos_embed"].shape[1] == 36
    small = _finetune_cfg("groups")
    small.image_size = 4
    tiny, _ = build_finetune_model(small, device="cpu")
    jax_checkpoint.save_checkpoint(str(tmp_path / "tiny.msgpack"),
                                   flax_from_params(tiny.state_dict()))
    with pytest.raises(AssertionError, match="smaller image_size"):
        load_pretrained_params(str(tmp_path / "tiny.msgpack"), cfg, model, seed=5)


def test_hyperx_restore_of_a_jax_saved_batchnorm_net(tmp_path):
    """liu (BatchNorm, semi-supervised): the JAX trainer's save of params and
    non-trivial batch_stats, restored by the port, gives the JAX eval
    logits (5e-4, the semi nets' limit); a bare-params file keeps the
    port's statistics; the port's .msgpack save restores in the JAX
    trainer leaf for leaf."""
    kwargs = dict(n_classes=5, n_bands=12, ignored_labels=[0])
    jmodel, jopt, jcrit, jhp = jax_get_model("liu", **kwargs)
    jt = JaxHyperXTrainer(jmodel, jopt, jcrit, jhp)
    rng = np.random.default_rng(8)
    jt.batch_stats = jax.tree_util.tree_map(
        lambda s: np.asarray(rng.uniform(0.5, 1.5, s.shape), np.float32), jt.batch_stats)
    path = str(tmp_path / "liu.msgpack")
    jt.save(path)
    model, opt, crit, hp = get_model("liu", seed=3, **kwargs)
    trainer = HyperXTrainer(model, opt, crit, hp, device="cpu")
    trainer.restore(path)
    x = rng.standard_normal((6, *model.input_shape)).astype(np.float32)
    want = np.asarray(jt._predict(jt.params, jt.batch_stats, jnp.asarray(x)))
    got = trainer.predict(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)

    stats = {k: v.clone() for k, v in trainer.model.state_dict().items() if "running" in k}
    bare = str(tmp_path / "bare.msgpack")
    with open(bare, "wb") as f:
        f.write(serialization.to_bytes(jax.tree_util.tree_map(np.asarray, jt.params)))
    model2, *_ = get_model("liu", seed=4, **kwargs)
    other = HyperXTrainer(model2, opt, crit, hp, device="cpu")
    own = {k: v.clone() for k, v in other.model.state_dict().items() if "running" in k}
    other.restore(bare)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, own[k] if "running" in k else trainer.model.state_dict()[k]), k
    assert any(not torch.equal(stats[k], own[k]) for k in stats)

    out = str(tmp_path / "port_liu.msgpack")
    trainer.save(out)
    jt2 = JaxHyperXTrainer(jmodel, jopt, jcrit, jhp)
    jt2.restore(out)
    for (k, a), b in zip(_leaves(jt.params).items(), _leaves(jt2.params).values()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)
    for (k, a), b in zip(_leaves(jt.batch_stats).items(), _leaves(jt2.batch_stats).values()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)


def test_export_tool_and_hyperx_inference_take_a_msgpack(tmp_path):
    """The export tool writes the same reference ``.pth`` from a JAX
    pretraining ``.msgpack`` (with the JAX sidecar's config) as from the
    ``.pt`` of the same weights; the HyperX inference CLI's
    ``predict_scene`` gives the same scene map from a ``.msgpack`` as from a
    ``.pt``."""
    pre = Pretrainer(_pretrain_cfg(), tile_size=32, device="cpu")
    msgpack_path, pt_path = str(tmp_path / "pre.msgpack"), str(tmp_path / "pre.pt")
    jax_checkpoint.save_checkpoint(msgpack_path, flax_from_params(pre.model.state_dict()),
                                   config=pre.config.to_dict())
    save_checkpoint(pt_path, pre.model.state_dict(), pre.config)
    n = export_checkpoint(msgpack_path, str(tmp_path / "a.pth"))
    assert n == export_checkpoint(pt_path, str(tmp_path / "b.pth")) > 0
    a = torch.load(str(tmp_path / "a.pth"), weights_only=True)["model_state_dict"]
    b = torch.load(str(tmp_path / "b.pth"), weights_only=True)["model_state_dict"]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    model, opt, crit, hp = get_model("li", n_classes=4, n_bands=10, ignored_labels=[0], seed=2)
    trainer = HyperXTrainer(model, opt, crit, hp, device="cpu")
    trainer.save(str(tmp_path / "li.msgpack"))
    trainer.save(str(tmp_path / "li.pt"))
    img = np.random.default_rng(0).random((9, 9, 10)).astype(np.float32)
    got = predict_scene("li", str(tmp_path / "li.msgpack"), img, 4, device="cpu")
    want = predict_scene("li", str(tmp_path / "li.pt"), img, 4, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
