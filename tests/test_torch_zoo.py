"""The DeepHyperX zoo of the port (``maskedsst_tpu_torch/models/zoo.py``)
against the JAX package's on the CPU: the port's seeded weights carried
across by ``io/flax_params.py``'s zoo converter, inputs from numpy seeds.

Tolerances: eval-mode forwards at the JAX suite's parity geometries
(tests/test_zoo.py, batch 3) atol 3e-5, rtol 1e-4, the semi-supervised
nets' outputs rtol 1e-3, atol 5e-4; gradients per tensor 1e-4 * max|ref|
(the nets without BatchNorm in eval mode against ``deterministic=True``;
liu, boulch and mou in a training-mode step, their running statistics
after it to 1e-5 * max|ref|, that step in float64 on both sides: batch
statistics over 3 rows, with flax's E[x²] − E[x]² variance, amplify fp32
rounding in both implementations past 1e-4 (liu 1.4e-3, mou 5e-4 between
the two fp32 runs); a bias whose gradient a training-mode BatchNorm's mean
subtraction cancels, zero in exact arithmetic, to 1e-4 x the net's
largest gradient); the optimizers after two steps 1e-6
relative to max|ref|; the li Finetuner's loss 2e-5 and its two steps'
updates (parameters after minus before) 1e-4 * max|ref update| per
tensor: SGD moves each weight by lr times its gradient and momentum, so
the updates carry the gradients' tolerance. One JAX compile per net."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_finetune_config as jax_config
from maskedsst_tpu.models import zoo as jzoo
from maskedsst_tpu.parallel.mesh import get_mesh
from maskedsst_tpu.train import optim as jax_optim
from maskedsst_tpu.train.factory import build_finetune_model as jax_build
from maskedsst_tpu.train.finetuner import Finetuner as JaxFinetuner
from maskedsst_tpu.train.finetuner import make_head_label_fn as jax_head_label_fn
from maskedsst_tpu.train.metrics import classification_report as jax_report
from maskedsst_tpu_torch.config import get_finetune_config
from maskedsst_tpu_torch.io.flax_params import (
    zoo_flax_from_state,
    zoo_flax_skeleton,
    zoo_state_from_flax,
)
from maskedsst_tpu_torch.io.torch_import import (
    export_li_et_al,
    export_zoo,
    import_li_et_al,
    import_zoo,
)
from maskedsst_tpu_torch.models import zoo
from maskedsst_tpu_torch.serve import Predictor
from maskedsst_tpu_torch.train import optim
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.finetuner import Finetuner
from maskedsst_tpu_torch.train.metrics import classification_report

N_CLASSES = 20
CONFIGS = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")

# name → (factory overrides, bands, input kind): tests/test_zoo.py's PARITY_CASES
PARITY = {
    "nn": ({}, 50, "flat"),
    "hu": ({}, 50, "flat"),
    "hamida": ({"patch_size": 5}, 50, "cube5d"),
    "lee": ({}, 50, "cube5d"),
    "chen": ({"patch_size": 27}, 100, "cube5d"),
    "li": ({"patch_size": 5}, 50, "cube5d"),
    "he": ({"patch_size": 7}, 50, "cube5d"),
    "luo": ({"patch_size": 3}, 50, "cube5d"),
    "sharma": ({"patch_size": 64}, 50, "cube5d"),
    "liu": ({"patch_size": 9}, 50, "cube4d"),
    "boulch": ({}, 50, "flat"),
    "mou": ({}, 50, "flat"),
}
BN_NETS = ("liu", "boulch", "mou")  # BatchNorm and no dropout: held in a training step
EVAL_GRAD_NETS = ("nn", "hu", "hamida", "lee", "chen", "li", "he", "luo")  # no BatchNorm
# biases added right before a training-mode BatchNorm: their gradients are
# zero but for rounding, so a scale of their own would hold rounding noise
BN_CANCELLED = {"liu": ("['conv1']['bias']", "['fc2_dec']['bias']", "['fc3_dec']['bias']")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch CPU work: the suite runs
    files in parallel workers, and torch's default pool oversubscribes the
    cores, where small ops stall."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_per_tensor(got: dict, want: dict, tol: float, zero=()):
    """Each tensor within ``tol`` x its max|ref|; those in ``zero`` within
    ``tol`` x the largest max|ref| of all."""
    assert set(got) == set(want)
    largest = max(float(np.abs(ref).max()) for ref in want.values())
    for key, ref in want.items():
        scale = largest if key in zero else max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(np.asarray(got[key]) - ref).max())
        assert err <= tol * scale, (key, err, scale)


_CACHE: dict = {}


def _case(name):
    """(port model with seeded weights and perturbed BatchNorm statistics,
    the same variables as a JAX tree, JAX model, input, hyperparameters),
    built once per net."""
    if name in _CACHE:
        return _CACHE[name]
    kw, bands, kind = PARITY[name]
    model, _, _, hp = zoo.get_model(name, n_classes=N_CLASSES, n_bands=bands,
                                    ignored_labels=[-1], seed=3, **kw)
    jmodel, _, _, _ = jzoo.get_model(name, n_classes=N_CLASSES, n_bands=bands,
                                     ignored_labels=[-1], **kw)
    p = hp["patch_size"]
    shape = {"flat": (3, bands), "cube4d": (3, bands, p, p), "cube5d": (3, 1, bands, p, p)}[kind]
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, zoo.BatchNorm):  # non-trivial running statistics
                mod.running_mean.copy_(torch.from_numpy(
                    rng.standard_normal(mod.running_mean.shape).astype(np.float32) * 0.1))
                mod.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, mod.running_var.shape).astype(np.float32)))
    like = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              deterministic=True))
    variables = zoo_flax_from_state(model.state_dict(), like)
    _CACHE[name] = (model, variables, jmodel, x, hp)
    return _CACHE[name]


def _projection(out, seed=11):
    """A fixed random projection of the outputs, the loss of the gradient
    checks (it reaches every output, both of a semi-supervised net's)."""
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(o.shape)).astype(np.float32) for o in outs]


def _jax_results(name):
    """JAX eval logits and, where held, the gradients (and the statistics
    after a training step), from one compile per mode."""
    key = ("jax", name)
    if key in _CACHE:
        return _CACHE[key]
    model, variables, jmodel, x, _ = _case(name)
    res = {}
    if name in EVAL_GRAD_NETS:
        def loss_fn(params, xx):
            out = jmodel.apply({"params": params}, xx, deterministic=True)
            proj = _projection(out)
            outs = out if isinstance(out, tuple) else (out,)
            return sum(jnp.sum(o * r) for o, r in zip(outs, proj)), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], jnp.asarray(x))
        res["grads"] = grads
    else:
        out = jax.jit(lambda v, xx: jmodel.apply(v, xx, deterministic=True))(
            variables, jnp.asarray(x))
    res["out"] = jax.tree_util.tree_map(np.asarray, out)
    if name in BN_NETS:
        def train_loss(params, stats, xx):
            out, upd = jmodel.apply({"params": params, "batch_stats": stats}, xx,
                                    deterministic=False, mutable=["batch_stats"])
            outs = out if isinstance(out, tuple) else (out,)
            proj = [r.astype(np.float64) for r in _projection(out)]
            return sum(jnp.sum(o * r) for o, r in zip(outs, proj)), upd

        with jax.enable_x64(True):
            v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
            (_, upd), grads = jax.jit(jax.value_and_grad(train_loss, has_aux=True))(
                v64["params"], v64["batch_stats"], x.astype(np.float64))
            res["grads"], res["stats"] = (jax.tree_util.tree_map(np.asarray, t)
                                          for t in (grads, upd["batch_stats"]))
    _CACHE[key] = res
    return res


@pytest.mark.parametrize("name", sorted(PARITY))
def test_forward_matches_jax(name):
    model, _, _, x, _ = _case(name)
    want = _jax_results(name)["out"]
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=5e-4)
    else:
        assert tuple(got.shape[1:]) == model.logits_shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=3e-5)


def test_li_forward_at_enmap_dfc_geometry():
    """li with 16 planes at 200 bands, 8x8 cubes, 8 classes."""
    model, _, _, hp = zoo.get_model("li", n_classes=8, n_bands=200, ignored_labels=[-1],
                                    patch_size=8, seed=1)
    jmodel, _, _, _ = jzoo.get_model("li", n_classes=8, n_bands=200, ignored_labels=[-1],
                                     patch_size=8)
    x = np.random.default_rng(2).standard_normal((4, 1, 200, 8, 8)).astype(np.float32)
    like = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(lambda v, xx: jmodel.apply(v, xx))(
        zoo_flax_from_state(model.state_dict(), like), jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=3e-5)


@pytest.mark.parametrize("name", EVAL_GRAD_NETS + BN_NETS)
def test_gradients_match_jax(name):
    model, variables, _, x, _ = _case(name)
    res = _jax_results(name)
    if name in BN_NETS:  # a training-mode step, in float64 (module docstring)
        model = copy.deepcopy(model).double().train()
        x = x.astype(np.float64)
    else:
        model.eval()
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(x))
    outs = out if isinstance(out, tuple) else (out,)
    proj = _projection(tuple(o.detach().numpy() for o in outs))
    sum((o * torch.from_numpy(r).to(o.dtype)).sum() for o, r in zip(outs, proj)).backward()
    grads = zoo_flax_from_state({n: p.grad for n, p in model.named_parameters()}, variables)
    _close_per_tensor(_leaves(grads["params"]), _leaves(res["grads"]), 1e-4,
                      zero=BN_CANCELLED.get(name, ()))
    if name in BN_NETS:
        stats = zoo_flax_from_state(dict(model.named_buffers()), variables)
        _close_per_tensor(_leaves(stats["batch_stats"]), _leaves(res["stats"]), 1e-5)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_flax_skeleton_nests_as_the_jax_variables(name):
    """Without a JAX tree at hand (writing a ``.msgpack``), the net's own
    ``flax_conv_wrappers`` nest its variables as the JAX net's init does."""
    model, variables, _, _, _ = _case(name)
    got = zoo_flax_from_state(model.state_dict(), zoo_flax_skeleton(model))
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert _leaves(got).keys() == {jax.tree_util.keystr(p) for p, _ in want}
    for key, value in _leaves(variables).items():
        np.testing.assert_array_equal(_leaves(got)[key], value)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_factory_defaults_match_jax(name):
    """Every recipe: the net's class, the optimizer spec, the criterion's
    weights and the hyperparameters the JAX factory returns."""
    kwargs = dict(n_classes=10, n_bands=100, ignored_labels=[-1])
    if name == "nn":
        kwargs["n_bands"] = 16  # the MLP's 4096-wide layers stay cheap
    model, opt, crit, hp = zoo.get_model(name, **kwargs)
    jmodel, jopt, jcrit, jhp = jzoo.get_model(name, **kwargs)
    assert type(model).__name__ == type(jmodel).__name__
    assert opt == jopt
    np.testing.assert_array_equal(crit["weight"], jcrit["weight"])
    assert crit["weight"][-1] == 0.0 and crit["weight"][:-1].min() == 1.0  # the -1 quirk
    weights, jweights = hp.pop("weights"), jhp.pop("weights")
    np.testing.assert_array_equal(weights, jweights)
    assert hp == jhp
    if name == "sharma":
        assert hp["scheduler"] == {"type": "MultiStepLR", "milestones": [15, 25], "gamma": 0.1}
    if name in ("liu", "boulch"):
        assert hp["supervision"] == "semi"
        assert model.aux_loss_weight == jmodel.aux_loss_weight


def _small_li():
    model, _, _, _ = zoo.get_model("li", n_classes=4, n_bands=12, ignored_labels=[0], seed=4)
    jmodel, _, _, _ = jzoo.get_model("li", n_classes=4, n_bands=12, ignored_labels=[0])
    like = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 1, 12, 5, 5))))
    return model, like


@pytest.mark.parametrize("groups", ["one", "head_lr", "linear_eval"])
@pytest.mark.parametrize("name,extra", [("SGD", {"momentum": 0.9}), ("Adagrad", {}),
                                        ("Adadelta", {})])
def test_optimizers_match_optax(name, extra, groups):
    """Two steps of the zoo's optimizers (coupled L2 5e-3) against the JAX
    package's optax chains, alone, with the li head (``fc``) at its own
    rate, and under linear eval, on the same parameters and gradients."""
    model, like = _small_li()
    lr, wd = 0.05, 5e-3
    head = {"one": {}, "head_lr": {"head_lr": 0.2},
            "linear_eval": {"linear_eval": True}}[groups]
    opt = optim.build_optimizer(model, lr, wd, name=name, head_label_fn=optim.make_head_label_fn(
        "li"), **extra, **head)
    tx = jax_optim.build_optimizer(name, lr, wd, head_label_fn=jax_head_label_fn("li"),
                                   **extra, **head)
    params = zoo_flax_from_state(model.state_dict(), like)["params"]
    state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        jgrads = zoo_flax_from_state({n: torch.from_numpy(g) for n, g in grads.items()}, like)
        updates, state = tx.update(jgrads["params"], state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    got = zoo_flax_from_state(model.state_dict(), like)["params"]
    _close_per_tensor(_leaves(got), _leaves(params), 1e-6)
    assert optim.get_learning_rates(opt) == pytest.approx(jax_optim.get_learning_rates(state))


def test_adagrad_puts_eps_inside_the_root_as_optax():
    """A gradient of 1e-6 on a fresh accumulator: optax's rsqrt(g² + eps)
    moves the weight by lr·g/sqrt(g² + 1e-10); torch's Adagrad by
    lr·g/(|g| + 1e-10), ~100x further."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = optim.Adagrad([p], lr=1.0)
    p.grad = torch.full((1,), 1e-6)
    opt.step()
    assert float(p.detach()) == pytest.approx(-1e-6 / np.sqrt(1e-12 + 1e-10), rel=1e-5)


def test_multistep_lr_matches_jax():
    """The sharma schedule (milestones 15, 25 of 30, x0.1) over 30 epochs,
    on head and backbone groups."""
    model, like = _small_li()
    opt = optim.build_optimizer(model, 0.05, name="SGD", head_lr=0.5,
                                head_label_fn=optim.make_head_label_fn("li"))
    tx = jax_optim.build_optimizer("SGD", 0.05, head_lr=0.5, head_label_fn=jax_head_label_fn("li"))
    state = tx.init(zoo_flax_from_state(model.state_dict(), like)["params"])
    sched, jsched = optim.MultiStepLR(opt, [15, 25]), jax_optim.MultiStepLR([15, 25])
    for epoch in range(30):
        sched.step(1.0)
        state = jsched.update(state, 1.0)
        assert optim.get_learning_rates(opt) == pytest.approx(
            jax_optim.get_learning_rates(state), rel=1e-6), epoch
    assert optim.get_learning_rates(opt) == pytest.approx([5e-3, 5e-4])
    sched2 = optim.MultiStepLR(opt, [15, 25])
    sched2.load_state_dict(sched.state_dict())
    assert sched2.epoch == 30


def test_classification_report_matches_jax():
    rng = np.random.default_rng(0)
    cm = rng.integers(0, 20, (6, 6)).astype(np.float32)
    cm[2] = 0  # a class neither true ...
    cm[:, 2] = 0  # ... nor predicted: F1 0
    got = classification_report(torch.from_numpy(cm))
    want = jax_report(jnp.asarray(cm))
    for key in ("accuracy", "f1", "kappa"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-7)


def _li_configs():
    cfg, jcfg = get_finetune_config(*CONFIGS), jax_config(*CONFIGS)
    for c in (cfg, jcfg):
        c.method_name, c.pixelwise, c.batch_size = "li", True, 4
        c.patch_sub = 1  # image_size 8, pixelwise: a 7x7 window around the center pixel
    return cfg, jcfg


def test_li_factory_matches_jax():
    cfg, jcfg = _li_configs()
    model, kwargs = build_finetune_model(cfg, dtype=torch.bfloat16, device="cpu")
    jmodel, jkwargs = jax_build(jcfg)
    assert isinstance(model, zoo.LiEtAl) and model.compute_dtype == torch.float32
    assert model.patch_size == jmodel.patch_size == 7
    assert kwargs["optimizer_override"] == jkwargs["optimizer_override"]
    np.testing.assert_array_equal(kwargs["class_weights"], jkwargs["class_weights"])
    assert {k: v for k, v in kwargs.items() if k not in ("optimizer_override", "class_weights")} \
        == {"center_pixel": True, "add_channel_dim": True}
    cfg.overwrite_li_optim = True
    _, kwargs = build_finetune_model(cfg, device="cpu")
    assert kwargs == {"center_pixel": True, "add_channel_dim": True}


def test_li_finetune_step_matches_jax(monkeypatch):
    """Two steps of the li recipe (SGD momentum 0.9, L2 5e-4, class weights
    with the last class zeroed, the cubes given their channel axis) through
    the port's Finetuner against the JAX Finetuner's loss and optax chain,
    on 7x7 windows of 8x8 tiles taken at the origin. The Finetuner selects
    cuDNN's deterministic algorithms for a zoo net (exact resume)."""
    cfg, jcfg = _li_configs()
    model, kwargs = build_finetune_model(cfg, device="cpu")
    jmodel, jkwargs = jax_build(jcfg)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    trainer = Finetuner(cfg, model, tile_size=64, **kwargs)
    assert torch.backends.cudnn.deterministic
    jt = JaxFinetuner(jcfg, jmodel, mesh=get_mesh(devices=jax.devices()[:1]), tile_size=64,
                      **jkwargs)
    like = jt.state.params
    params = zoo_flax_from_state(model.state_dict(), like)["params"]
    before = _leaves(params)
    vg = jax.jit(jax.value_and_grad(jt._forward_loss, has_aux=True), static_argnums=(4,))
    tx, opt_state = jt.state.tx, jt.state.tx.init(params)
    rng = np.random.default_rng(3)
    for step in range(2):
        img = rng.standard_normal((4, 200, 8, 8)).astype(np.float32)
        label = rng.integers(0, 8, (4, 8, 8))
        label[0, 3, 3] = -1  # ignored
        label[1, 3, 3] = 7  # the class the -1 quirk weighs 0
        m = trainer.train_step(img, label, xy=(0, 0))
        (loss, _), grads = vg(params, jnp.asarray(img[:, :, :7, :7]),
                              jnp.asarray(label[:, 3, 3]), jax.random.PRNGKey(0), True)
        assert float(m["loss"]) == pytest.approx(float(loss), rel=2e-5)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    got, want = _leaves(zoo_flax_from_state(model.state_dict(), like)["params"]), _leaves(params)
    _close_per_tensor({k: got[k] - before[k] for k in got},
                      {k: want[k] - before[k] for k in want}, 1e-4)
    assert trainer.state.optimizer.state  # SGD momentum buffers, saved by a checkpoint
    assert all("momentum_buffer" in s for s in trainer.state.optimizer.state.values())


def test_predictor_serves_a_tuple_nets_logits():
    """boulch returns (logits, reconstruction): Predictor serves the logits,
    the JAX forward's, through a ragged tail."""
    model, _, _, x, _ = _case("boulch")
    want = _jax_results("boulch")["out"][0]
    got = Predictor(model, batch_size=2, device="cpu")(x)
    assert got.shape == (3, N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)
    empty = Predictor(model, batch_size=2, device="cpu")(x[:0])
    assert empty.shape == (0, N_CLASSES)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_flax_converter_round_trip_is_exact(name):
    model, variables, _, _, _ = _case(name)
    sd = zoo_state_from_flax(variables)
    want = model.state_dict()
    assert set(sd) == set(want)
    for key, val in want.items():
        assert torch.equal(sd[key], val), key
    back = zoo_flax_from_state(sd, variables)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["liu", "mou", "boulch"])
def test_importer_and_exporter_round_trip(name):
    """A reference-keyed state dict (the port's, with the entries the
    reference has and the port skips: BatchNorm counters, Liu's unused
    fc1_dec_bn) imports to the port's state dict; the export is its exact
    inverse; a wrong shape or an unknown entry raises."""
    model, _, _, _, _ = _case(name)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ref = dict(sd)
    for key in sd:
        if key.endswith("running_mean"):
            ref[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(3)
    if name == "liu":
        ref.update({f"fc1_dec_bn.{k}": torch.zeros(720) for k in
                    ("weight", "bias", "running_mean", "running_var")})
    got = import_zoo(ref, model)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    back = export_zoo(got)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert all(torch.equal(v, sd[k]) for k, v in import_zoo(back, model).items())
    key = next(iter(sd))
    with pytest.raises(ValueError, match="shape"):
        import_zoo({key: torch.zeros(3, 3, 3)}, model)
    with pytest.raises(KeyError, match="no counterpart"):
        import_zoo({"gru.weight_ih_l1": torch.zeros(3)}, model)


def test_li_importer_round_trip():
    model, _ = _small_li()
    sd = model.state_dict()
    got = import_li_et_al(export_li_et_al(sd), model)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(KeyError, match="lacks"):
        import_li_et_al({k: v for k, v in sd.items() if not k.startswith("fc")}, model)


def test_dropout_draws_from_the_generator_only_in_training():
    """chen's three dropout sites: eval draws nothing and is deterministic;
    a training call's masks follow the generator's seed, and the rows of a
    data-parallel shard are the global batch's masks' rows."""
    model, _, _, x, _ = _case("chen")
    xt = torch.from_numpy(np.concatenate([x, x]))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with torch.no_grad():
        model.eval()
        model(xt, rng=gen)
        assert torch.equal(gen.get_state(), state)
        model.train()
        a = model(xt, rng=torch.Generator().manual_seed(1))
        b = model(xt, rng=torch.Generator().manual_seed(1))
        c = model(xt, rng=torch.Generator().manual_seed(2))
        lo = model(xt[:3], rng=torch.Generator().manual_seed(1), shard=(0, 2))
        hi = model(xt[3:], rng=torch.Generator().manual_seed(1), shard=(1, 2))
    model.eval()
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(torch.cat([lo, hi]), a, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model.train()(xt)
    model.eval()
