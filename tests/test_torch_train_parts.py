"""The port's training parts against the JAX package, on the CPU: losses,
metrics, the Adam recipe with head/backbone groups and linear eval, the
plateau scheduler, windows, the dataset split, the loader, the synthetic
tiles and the validation schedule.

Tolerances: losses and metrics within 1e-6 (fp32, one log-softmax); Adam
trajectories on identical gradients within rtol 5e-4 (the figure the JAX
suite holds trajectories to, VERDICT.md); learning rates, indices, tiles
and windows exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskedsst_tpu.config import get_finetune_config as jax_config
from maskedsst_tpu.data import pipeline as jax_pipeline
from maskedsst_tpu.data.synthetic import SyntheticCubeDataset as JaxCubes
from maskedsst_tpu.train import losses as jax_losses
from maskedsst_tpu.train import metrics as jax_metrics
from maskedsst_tpu.train import optim as jax_optim
from maskedsst_tpu.train.finetuner import get_val_epochs as jax_val_epochs
from maskedsst_tpu.train.finetuner import make_head_label_fn as jax_head_fn
from maskedsst_tpu.train.windows import window_tiles as jax_windows
from maskedsst_tpu_torch.config import get_finetune_config
from maskedsst_tpu_torch.data import pipeline
from maskedsst_tpu_torch.data.resolve import get_dataset
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.io.flax_params import flax_from_params
from maskedsst_tpu_torch.train import losses, metrics, optim
from maskedsst_tpu_torch.train.finetuner import get_val_epochs
from maskedsst_tpu_torch.train.windows import window_tiles

CONFIGS = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")


def _logits_targets(shape, c, seed, ignored=0.2):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((shape[0], c, *shape[1:])).astype(np.float32) * 3
    targets = rng.integers(0, c, shape)
    targets[rng.random(shape) < ignored] = -1
    return logits, targets


@pytest.mark.parametrize("shape", [(16,), (3, 8, 8)], ids=["2d", "4d"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(shape, weighted):
    logits, targets = _logits_targets(shape, 8, 0)
    weight = np.random.default_rng(1).random(8).astype(np.float32) if weighted else None
    jw = None if weight is None else jnp.asarray(weight)
    tw = None if weight is None else torch.from_numpy(weight)
    want = float(jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(targets), -1, jw))
    got = float(losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), -1, tw))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    wn, ww = jax_losses.cross_entropy_sums(jnp.asarray(logits), jnp.asarray(targets), -1, jw)
    gn, gw = losses.cross_entropy_sums(torch.from_numpy(logits), torch.from_numpy(targets), -1, tw)
    assert abs(float(gn) - float(wn)) <= 1e-6 * max(1.0, abs(float(wn)))
    assert abs(float(gw) - float(ww)) <= 1e-6 * max(1.0, abs(float(ww)))


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.randn(4, 8)
    assert float(losses.cross_entropy(logits, torch.full((4,), -1))) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    label = rng.integers(-1, 8, (3, 8, 8))
    pred = rng.integers(0, 8, (3, 8, 8))
    pred[0, 0, :3] = [8, 11, -2]  # out-of-range ids count nowhere
    label[1, 0, :2] = [9, 8]
    jp, jl, tp, tl = jnp.asarray(pred), jnp.asarray(label), torch.from_numpy(pred), torch.from_numpy(label)
    np.testing.assert_array_equal(metrics.confusion_matrix(tp, tl, 8).numpy(),
                                  np.asarray(jax_metrics.confusion_matrix(jp, jl, 8)))
    assert abs(float(metrics.micro_accuracy(tp, tl)) - float(jax_metrics.micro_accuracy(jp, jl))) < 1e-6
    assert abs(float(metrics.macro_accuracy(tp, tl, 8))
               - float(jax_metrics.macro_accuracy(jp, jl, 8))) < 1e-6


def test_micro_accuracy_with_nothing_valid_is_zero():
    assert float(metrics.micro_accuracy(torch.zeros(4), torch.full((4,), -1))) == 0.0


class _Tiny(torch.nn.Module):
    """Names as the ViT's: a head, a feed-forward fc1 (not head) and a norm."""

    def __init__(self):
        super().__init__()
        self.head_linear = torch.nn.Linear(6, 3)
        self.ff = torch.nn.Module()
        self.ff.fc1 = torch.nn.Linear(4, 6)
        self.head_norm = torch.nn.LayerNorm(6)
        self.blockwise_kernel = torch.nn.Parameter(torch.randn(2, 3, 4))


@pytest.mark.parametrize(
    "head_lr,linear_eval",
    [(0.005, False), (0.0005, False), (None, True)],
    ids=["groups", "one_group", "linear_eval"],
)
def test_adam_recipe_matches_optax(head_lr, linear_eval):
    """torch Adam(weight_decay) in head/rest groups against the optax chain
    of build_optimizer, 5 steps on identical gradients."""
    torch.manual_seed(0)
    model = _Tiny()
    lr, wd = 0.0005, 0.005
    opt = optim.build_optimizer(model, lr, wd, head_lr=head_lr,
                                head_label_fn=optim.make_head_label_fn(None),
                                linear_eval=linear_eval)
    tx = jax_optim.build_optimizer("Adam", lr, wd, head_lr=head_lr,
                                   head_label_fn=jax_head_fn(None), linear_eval=linear_eval)
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_params(model.state_dict()))
    state = tx.init(params)
    assert optim.get_learning_rates(opt) == pytest.approx(jax_optim.get_learning_rates(state))
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
        jg = jax.tree_util.tree_map(jnp.asarray, flax_from_params(grads))
        updates, state = tx.update(jg, state, params)
        params = optax.apply_updates(params, updates)
    got = flax_from_params(model.state_dict())
    for (path, want), (_, have) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                       jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(have, np.asarray(want), rtol=5e-4, atol=1e-7, err_msg=str(path))
    if linear_eval:  # the backbone never moves
        np.testing.assert_array_equal(got["ff"]["fc1"]["kernel"],
                                      flax_from_params(_Tiny_reference())["ff"]["fc1"]["kernel"])


def _Tiny_reference():
    torch.manual_seed(0)
    return _Tiny().state_dict()


def test_head_label_fn_never_takes_the_feed_forward():
    is_head = optim.make_head_label_fn("ViTSpatialSpectral")
    assert is_head("head_linear.weight") and is_head("head_norm.bias")
    assert not is_head("spectral_transformer.layers.0.ff.fc1.weight")
    assert optim.make_head_label_fn("li")("fc1.weight")


def test_plateau_scheduler_matches_jax():
    """The same learning-rate sequence from the same validation losses."""
    model = _Tiny()
    opt = optim.build_optimizer(model, 0.0005, 0.005, head_lr=0.005,
                                head_label_fn=optim.make_head_label_fn(None))
    sched = optim.plateau_scheduler(opt)
    tx = jax_optim.build_optimizer("Adam", 0.0005, 0.005, head_lr=0.005,
                                   head_label_fn=jax_head_fn(None))
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, flax_from_params(model.state_dict())))
    jsched = jax_optim.ReduceLROnPlateau(factor=0.9, patience=5)
    metric_seq = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.94, 0.899999, 0.9, 0.8] + [0.85] * 14
    for m in metric_seq:
        sched.step(m)
        state = jsched.update(state, m)
        assert optim.get_learning_rates(opt) == pytest.approx(
            jax_optim.get_learning_rates(state), rel=1e-6)
    assert optim.get_learning_rates(opt)[0] < 0.005  # it did reduce


@pytest.mark.parametrize("groups", ["pretrain", "head_backbone"])
def test_plateau_scheduler_keeps_cutting_small_rates_as_jax(groups):
    """800 flat epochs (a validation loss of 1.0 each): the JAX scheduler
    cuts every sixth epoch however small the rate; torch's default eps 1e-8
    would stop cutting at 1e-7 (from lr 0.008 at epoch 654, ending at
    9.15e-8 against JAX's 6.57e-9). The pretraining recipe's single AdamW
    group from 0.008, and the finetune recipe's head and backbone groups.
    JAX holds each rate in fp32, one rounding per cut (133 cuts): rel 1e-5."""
    model = _Tiny()
    if groups == "pretrain":
        opt = optim.build_pretrain_optimizer(model, "AdamW", 0.008, 0.05)
        tx = jax_optim.build_optimizer("AdamW", 0.008, 0.05)
    else:
        opt = optim.build_optimizer(model, 0.0005, 0.005, head_lr=0.005,
                                    head_label_fn=optim.make_head_label_fn(None))
        tx = jax_optim.build_optimizer("Adam", 0.0005, 0.005, head_lr=0.005,
                                       head_label_fn=jax_head_fn(None))
    sched = optim.plateau_scheduler(opt)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, flax_from_params(model.state_dict())))
    jsched = jax_optim.ReduceLROnPlateau(factor=0.9, patience=5)
    start = optim.get_learning_rates(opt)
    for _ in range(800):
        sched.step(1.0)
        state = jsched.update(state, 1.0)
        assert optim.get_learning_rates(opt) == pytest.approx(
            jax_optim.get_learning_rates(state), rel=1e-5)
    for lr, lr0 in zip(optim.get_learning_rates(opt), start):
        assert lr == pytest.approx(lr0 * 0.9 ** 133, rel=1e-12)
    if groups == "pretrain":
        assert optim.get_learning_rates(opt)[0] == pytest.approx(6.57e-9, rel=1e-3)


def test_set_learning_rates():
    opt = optim.build_optimizer(_Tiny(), 0.001, 0.0, head_lr=0.01,
                                head_label_fn=optim.make_head_label_fn(None))
    optim.set_learning_rates(opt, [0.2, 0.1])
    assert optim.get_learning_rates(opt) == [0.2, 0.1]
    with pytest.raises(ValueError):
        optim.set_learning_rates(opt, [0.1])


@pytest.mark.parametrize("tile,s", [(64, 8), (16, 8), (8, 8), (20, 8)])
def test_window_tiles_match_jax(tile, s):
    rng = np.random.default_rng(tile)
    img = rng.standard_normal((2, 3, tile, tile)).astype(np.float32)
    label = rng.integers(0, 5, (2, tile, tile))
    want = jax_windows(img, s, label)
    for got in (window_tiles(img, s, label),
                [t.numpy() for t in window_tiles(torch.from_numpy(img), s, torch.from_numpy(label))]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="exceeds"):
        window_tiles(img, tile + 1, label)


@pytest.mark.parametrize("flag", [True, None])
def test_subset_forwards_stochastic_as_jax(flag):
    """A subset reads its dataset's ``stochastic`` flag (False where the
    dataset has none), as the JAX Subset does: the trainers stream a
    stochastic dataset from the host instead of freezing one draw."""

    class Stub:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"img": np.zeros(2, np.float32), "label": np.int64(i)}

    ds = Stub()
    if flag is not None:
        ds.stochastic = flag
    val, train = pipeline.split_dataset(ds, 0.8, seed=5)
    jval, jtrain = jax_pipeline.split_dataset(ds, 0.8, seed=5)
    assert (val.stochastic, train.stochastic) == (jval.stochastic, jtrain.stochastic)
    assert train.stochastic is bool(flag)


def test_split_and_loader_match_jax():
    ds = SyntheticCubeDataset(num_tiles=23, n_bands=20, tile_size=8, n_classes=4, seed=3)
    jds = JaxCubes(num_tiles=23, n_bands=20, tile_size=8, n_classes=4, seed=3)
    val, train = pipeline.split_dataset(ds, 0.8, 0.9, seed=5)
    jval, jtrain = jax_pipeline.split_dataset(jds, 0.8, 0.9, seed=5)
    assert val.indices == jval.indices and train.indices == jtrain.indices
    for kw in (dict(shuffle=True, seed=7, pad_to_multiple=4, pad_label_value=-1),
               dict(shuffle=False)):
        loader = pipeline.DataLoader(train, 4, **kw)
        jloader = jax_pipeline.DataLoader(jtrain, 4, prefetch=0, **kw)
        assert len(loader) == len(jloader)
        for _ in range(2):  # two epochs: the shuffle is seeded per epoch
            for got, want in zip(loader, jloader, strict=True):
                for key in ("img", "label"):
                    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("idx", [0, 5])
def test_synthetic_tiles_equal_jax(idx):
    got = SyntheticCubeDataset(num_tiles=8, seed=2)[idx]
    want = JaxCubes(num_tiles=8, seed=2)[idx]
    for key in ("img", "label"):
        np.testing.assert_array_equal(got[key], want[key])


def test_get_dataset_synthetic():
    cfg = get_finetune_config(*CONFIGS)
    cfg.synthetic_tiles = 4
    ds = get_dataset(cfg, supervised=True, synthetic=True)
    assert len(ds) == 4 and ds[0]["img"].shape == (200, 64, 64) and ds[0]["label"].shape == (64, 64)
    np.testing.assert_array_equal(ds[1]["img"], JaxCubes(num_tiles=4, n_bands=200, n_classes=8,
                                                         seed=cfg.seed)[1]["img"])
    hcfg = get_finetune_config("configs/finetune_config_houston2018.yaml", CONFIGS[1])
    hcfg.synthetic_tiles = 2
    hds = get_dataset(hcfg, supervised=True, synthetic=True)
    assert hds[0]["img"].shape == (50, 8, 8)  # 5 spectral blocks: seq 5
    # the real branch: the config's dfc train_path is not in the repo
    with pytest.raises(FileNotFoundError, match="data/enmap_dfc_dataset/MexicoCity/train"):
        get_dataset(cfg, supervised=True, synthetic=False)


@pytest.mark.parametrize("spe,epoch,max_steps", [(10, 100, 1000), (10, 5, 1000), (3, 4, 7)])
def test_val_epochs_match_jax(spe, epoch, max_steps):
    cfg, jcfg = get_finetune_config(*CONFIGS), jax_config(*CONFIGS)
    for c in (cfg, jcfg):
        c.epoch, c.max_steps = epoch, max_steps
    assert get_val_epochs(cfg, spe) == jax_val_epochs(jcfg, spe)
