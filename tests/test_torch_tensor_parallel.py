"""Tensor parallelism over attention heads in the port (``parallel/mesh.py``'s
grid, ``parallel/sharding_rules.py``, ``ops/tp_layer.py``), on the CPU.

Two and four Gloo ranks run ``tools/dist_worker.py``'s ``tensor_parallel``
and ``tp_logits`` cases through ``dist_worker.launch``, torch pinned to one
thread a rank, at narrow widths (40 bands, dim 24, 1 + 1 layers, 4 heads,
MLP 21: an uneven split of the MLP width).

Against the JAX package (``maskedsst_tpu/parallel/sharding_rules.py`` and
the unfused model, ``fused=False``, on ``tests/test_tensor_parallel.py``'s
geometry: dim 96, depth 2, 8 heads, MLP 64, 40 bands): the split axis of
every leaf; a tp = 2 SimMIM loss within 2e-5·|ref| of JAX's replicated
``mim.apply`` with the same masks; a tp = 2 classifier's logits within
2e-5.

Against the port's one-process step (the fused layer's plain versions): a
tp = 2 step and a 2 × 2 step, at dropout 0 and 0.1, in the loss
(2e-5·|ref|), each gathered gradient (1e-4·max|ref|) and the parameters
after two steps (1e-2·lr). Each data rank folds its layers' dropout seeds
by its data index, as JAX does, so the 2 × 2 step at dropout 0.1 is held
against the two-process data-parallel step on the fused layer (the same
launch), whose masks it draws; at tp = 2 the masks are the one-process
masks. Every mask is held bit for bit to the slice of ``dropout_mask``
it names; the ranks of a model group are bit-equal on their whole
(replicated) leaves; each rank's shard is bit-equal to the slice of the
gathered tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.models import ViTSpatialSpectral as JaxViT
from maskedsst_tpu.ops.masking import MaskGenerator
from maskedsst_tpu.parallel.mesh import get_mesh
from maskedsst_tpu.parallel.sharding_rules import tensor_parallel_shardings as jax_shardings
from maskedsst_tpu_torch.config import get_pretrain_config
from maskedsst_tpu_torch.io.flax_params import flax_from_params, flax_path, params_from_flax
from maskedsst_tpu_torch.models.layers import fold_rank_seed
from maskedsst_tpu_torch.ops.fused_layer import SITE_ATTN, SITE_FF_MID, dropout_mask
from maskedsst_tpu_torch.parallel.mesh import DataWorld, Grid, make_grid
from maskedsst_tpu_torch.parallel.sharding_rules import (
    head_split,
    place_params,
    shard_index,
    split_axis,
    tensor_parallel_shardings,
)
from maskedsst_tpu_torch.tools import dist_worker
from maskedsst_tpu_torch.train.pretrainer import build_pretrain_model
from tests.test_tensor_parallel import _model as jax_model

CONFIGS = ["configs/pretrain_config.yaml", "configs/config.yaml"]
NARROW = dict(n_bands=40, transformer_dim=24, transformer_depth=1, transformer_n_heads=4,
              transformer_mlp_dim=21, batch_size=4, seed=0)
# tests/test_tensor_parallel.py's geometry, as the pretraining config gives it
JAX_GEOMETRY = dict(n_bands=40, transformer_dim=96, transformer_depth=2, transformer_n_heads=8,
                    transformer_mlp_dim=64, spectral_pos_embed=True, batch_size=4, seed=0,
                    transformer_dropout=0.0, transformer_emb_dropout=0.0)
VIT = dict(image_size=8, spatial_patch_size=1, spectral_patch_size=10, num_classes=6, dim=24,
           depth=1, heads=4, dim_head=8, mlp_dim=21, channels=40)
RATE = 0.1
STEPS = 2
LOSS_TOL, GRAD_TOL, PARAM_TOL = 2e-5, 1e-4, 1e-2


def _case(name, model, rate, **kw):
    return dict(kind="tensor_parallel", name=name, configs=CONFIGS, model=model, steps=STEPS,
                tiles=8, arrays=True, record_masks=True, record_seeds=True,
                set=dict(NARROW, transformer_dropout=rate), **kw)


TWO = [
    _case("tp_d0", 2, 0.0, all_ranks_arrays=True),
    _case("tp_d1", 2, RATE),
    _case("dp_d1", 1, RATE),  # two data ranks on the fused layer: 2 x 2's reference
    dict(kind="tensor_parallel", name="jax_loss", configs=CONFIGS, model=2, steps=1,
         img="jimg", mask="jmask", params="jparams/", set=JAX_GEOMETRY),
    dict(kind="tp_logits", name="logits", model=2, vit=VIT, params="vit/"),
]
FOUR = [
    _case("g_d0", 2, 0.0, all_ranks_arrays=True),
    _case("g_d1", 2, RATE),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_geometry_cfg():
    cfg = get_pretrain_config(*CONFIGS)
    for key, value in JAX_GEOMETRY.items():
        setattr(cfg, key, value)
    return cfg


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Weights, cubes and masks of the JAX-held cases, and the JAX results."""
    rng = np.random.default_rng(0)
    arrays = {}
    mim_model = build_pretrain_model(_jax_geometry_cfg(), device="cpu")
    for k, v in mim_model.state_dict().items():
        arrays[f"jparams/{k}"] = v.numpy()
    arrays["jimg1"] = rng.standard_normal((4, 40, 8, 8)).astype(np.float32)
    arrays["jmask1"] = np.asarray(MaskGenerator(8, 4, 1, 0.7).batch_masks(
        jax.random.PRNGKey(3), 4, 4, True))
    _, mim = jax_model()
    jparams = jax.tree_util.tree_map(jnp.asarray, flax_from_params(mim_model.state_dict()))
    loss = float(jax.jit(lambda p, x, m: mim.apply({"params": p}, x, deterministic=True,
                                                   bool_mask=m))(
        jparams, jnp.asarray(arrays["jimg1"]), jnp.asarray(arrays["jmask1"])))

    vit = JaxViT(**VIT, fused=False)
    arrays["img"] = rng.standard_normal((4, 40, 8, 8)).astype(np.float32)
    variables = jax.jit(lambda k, x: vit.init(k, x, deterministic=True))(
        jax.random.PRNGKey(1), jnp.asarray(arrays["img"]))
    for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        variables["params"])).items():
        arrays[f"vit/{k}"] = v.numpy()
    logits = np.asarray(jax.jit(lambda v, x: vit.apply(v, x, deterministic=True))(
        variables, jnp.asarray(arrays["img"])))
    path = tmp_path_factory.mktemp("tp_inputs") / "inputs.npz"
    np.savez(path, **arrays)
    return dict(path=str(path), arrays=arrays, jax_loss=loss, jax_logits=logits)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The 2- and 4-rank launches and the one-process runs of their cases."""
    out = {}
    for label, cases, size in (("two", TWO, 2), ("four", FOUR, 4)):
        spec = dict(out=str(tmp_path_factory.mktemp(label)), device="cpu", backend="gloo",
                    threads=1, inputs=inputs["path"], cases=cases)
        results = dist_worker.launch(spec, size, timeout_s=300)
        out[label] = dict(ranks=[r["cases"] for r in results],
                          arrays=[dist_worker.load_arrays(spec["out"], r) for r in range(size)])
    one_dir = str(tmp_path_factory.mktemp("one"))
    out["one"] = {rate: dist_worker.run_case(_case("one", 1, rate, out=one_dir), DataWorld(), {})
                  for rate in (0.0, RATE)}
    return out


# --- the rules -----------------------------------------------------------------------

def test_sharding_rules_match_jax():
    """Every leaf of the JAX test model's tree takes the split axis JAX's
    rules give it (P(None, 'model') → flax axis 1, P('model', None) → 0),
    through io/flax_params.py's names and transposes."""
    _, mim = jax_model()
    shapes = jax.eval_shape(lambda: mim.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((2, 40, 8, 8)), deterministic=True))["params"]
    specs = jax_shardings(shapes, get_mesh(model_axis=2), heads=8)
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        axes = [i for i, a in enumerate(spec.spec) if a == "model"]
        want[tuple(k.key for k in path)] = axes[0] if axes else None
    model = build_pretrain_model(_jax_geometry_cfg(), device="cpu")
    got = {}
    for name, axis in tensor_parallel_shardings(model, Grid(model_size=2), 8).items():
        path, transposed = flax_path(name, model.get_parameter(name).dim())
        got[tuple(path)] = None if axis is None else (1 - axis if transposed else axis)
    assert got == want
    assert sum(v is not None for v in got.values()) == 16  # 4 weights x 2 layers x 2 stacks


def test_heads_must_divide_the_model_axis():
    model = build_pretrain_model(_jax_geometry_cfg(), device="cpu")
    with pytest.raises(ValueError, match="must divide over the model axis"):
        tensor_parallel_shardings(model, Grid(model_size=3), 8)
    with pytest.raises(ValueError, match="must divide over the model axis"):
        place_params(model, Grid(model_size=3))
    with pytest.raises(ValueError, match="!= the world size"):
        make_grid(DataWorld(size=4, rank=1), model_axis=3, data_axis=2)
    assert place_params(model, make_grid(DataWorld())) is model  # model size 1: unchanged
    assert all(b.tp is None for b in model.modules() if hasattr(b, "tp"))


def test_trainers_refuse_a_model_axis():
    """JAX's check_fused_mesh: the fused kernels take data parallelism
    only; the port has no unfused trainer, so both trainers raise."""
    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.train.factory import build_finetune_model, check_fused_mesh
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    grid = Grid(size=1, model_size=2)
    with pytest.raises(ValueError, match="data parallelism only"):
        check_fused_mesh(grid)
    check_fused_mesh(Grid())  # a pure data grid
    check_fused_mesh(DataWorld())
    cfg = get_pretrain_config(*CONFIGS)
    for key, value in NARROW.items():
        setattr(cfg, key, value)
    with pytest.raises(ValueError, match="data parallelism only"):
        Pretrainer(cfg, device="cpu", world=grid)
    fcfg = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml")
    for key, value in {**NARROW, "spectral_pos": fcfg.spectral_pos[:4]}.items():
        setattr(fcfg, key, value)
    model, kw = build_finetune_model(fcfg, device="cpu")
    with pytest.raises(ValueError, match="data parallelism only"):
        Finetuner(fcfg, model, world=grid, **kw)


# --- against the JAX package -----------------------------------------------------------

def test_tp2_simmim_loss_matches_jax(inputs, runs):
    ranks = runs["two"]["ranks"]
    for rank in ranks:
        got = rank["jax_loss"]["steps"][0]["loss"]
        assert abs(got - inputs["jax_loss"]) <= LOSS_TOL * abs(inputs["jax_loss"]), (
            got, inputs["jax_loss"])


def test_tp2_classifier_logits_match_jax(inputs, runs):
    got = runs["two"]["arrays"][0]["logits/logits"]
    np.testing.assert_allclose(got, inputs["jax_logits"], rtol=0, atol=2e-5)


# --- against the port's one-process step ----------------------------------------------

HELD = {"tp_d0": ("two", 0.0), "tp_d1": ("two", RATE), "g_d0": ("four", 0.0),
        "g_d1": ("four", "dp_d1")}


def _reference(runs, name):
    label, ref = HELD[name]
    if ref == "dp_d1":  # the two-rank data-parallel step on the fused layer
        two = runs["two"]
        return two["ranks"][0]["dp_d1"], {k.replace("dp_d1/", "one/"): v
                                          for k, v in two["arrays"][0].items()
                                          if k.startswith("dp_d1/")}
    return runs["one"][ref]


@pytest.mark.parametrize("name", sorted(HELD))
def test_step_matches_the_reference(runs, name):
    label, _ = HELD[name]
    ranks, arrays = runs[label]["ranks"], runs[label]["arrays"][0]
    ref, ref_arrays = _reference(runs, name)
    lr = get_pretrain_config(*CONFIGS).lr
    for rank in ranks:
        assert rank[name]["round_trip"]  # gather_params of place_params: the same bits
        for got, want in zip(rank[name]["steps"], ref["steps"]):
            assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
            assert got["launches"]["fused_layer_fwd"] == got["launches"]["fused_layer_bwd"] == 0
    for k in range(1, STEPS + 1):
        for key, want in ref_arrays.items():
            if f"/grads{k}/" in key:
                got = arrays[key.replace("one/", f"{name}/")]
                err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
                assert err <= GRAD_TOL, (key, err)
            if f"/params{k}/" in key:
                got = arrays[key.replace("one/", f"{name}/")]
                assert np.abs(got - want).max() <= PARAM_TOL * lr, key


@pytest.mark.parametrize("name", ["tp_d1", "g_d1"])
def test_dropout_masks_are_the_reference_masks(runs, name):
    """Each mask a head-split layer draws equals its slice of the
    one-process layer's ``dropout_mask`` at the same seed, bit for bit;
    data rank d's seeds are the reference's folded by d."""
    label, _ = HELD[name]
    ranks = runs[label]["ranks"]
    ref, _ = _reference(runs, name)
    for r, rank in enumerate(ranks):
        grid = rank[name]["grid"]
        masks = rank[name]["masks"]
        assert len(masks) == 4 * 2 * (STEPS + 0)  # four sites, two layers, each step
        seeds = [m["seed"] for m in masks[::4]]
        if name == "tp_d1":
            assert seeds == ref["seeds"]
        else:  # rank (d, m): the data-parallel rank d's seeds
            want = [fold_rank_seed(s, grid[0]) if grid[0] else s
                    for s in runs["two"]["ranks"][0]["dp_d1"]["seeds"]]
            assert seeds == want
        for m in masks:
            shape, base, stride = m["shape"], m["base"], m["row_stride"]
            if m["site"] == SITE_ATTN:
                s2 = shape[2] * shape[3]
                full = dropout_mask((shape[0], stride // s2, shape[2], shape[3]), m["seed"],
                                    m["site"], RATE)
                want = full[:, base // s2 : base // s2 + shape[1]]
                assert base // s2 == grid[2] * shape[1]
            elif m["site"] == SITE_FF_MID:
                want = dropout_mask((shape[0], stride), m["seed"], m["site"], RATE)[
                    :, base : base + shape[1]]
            else:
                want = dropout_mask(shape, m["seed"], m["site"], RATE)
                assert base == 0
            assert dist_worker.digest([want.contiguous()]) == m["digest"], m


@pytest.mark.parametrize("label,names", [("two", ["tp_d0", "tp_d1"]),
                                         ("four", ["g_d0", "g_d1"])])
def test_ranks_agree(runs, label, names):
    """The grid is row-major (rank r: data r // 2, model r % 2); the whole
    leaves (parameters and gradients) are bit-equal on every rank, the
    local shards across the data ranks of one model index."""
    ranks = runs[label]["ranks"]
    for name in names:
        grids = [rank[name]["grid"] for rank in ranks]
        assert grids == [[r // 2, len(ranks) // 2, r % 2, 2] for r in range(len(ranks))]
        for k in range(STEPS):
            steps = [rank[name]["steps"][k] for rank in ranks]
            assert len({s["whole_digest"] for s in steps}) == 1
            for m in range(2):
                assert len({s["params_digest"] for s, g in zip(steps, grids) if g[2] == m}) == 1
                assert len({s["grads_digest"] for s, g in zip(steps, grids) if g[2] == m}) == 1


@pytest.mark.parametrize("label,name", [("two", "tp_d0"), ("four", "g_d0")])
def test_shards_are_slices_of_the_gathered_tensors(runs, label, name):
    arrays = runs[label]["arrays"]
    ranks = runs[label]["ranks"]
    cfg = get_pretrain_config(*CONFIGS)
    heads, mlp = NARROW["transformer_n_heads"], NARROW["transformer_mlp_dim"]
    checked = 0
    for r, rank in enumerate(ranks):
        m = rank[name]["grid"][2]
        split = head_split(heads, mlp, 2, m)
        for k in range(1, STEPS + 1):
            for key, local in arrays[r].items():
                if not key.startswith(f"{name}/local{k}/"):
                    continue
                leaf_name = key.split("/", 2)[2]
                assert split_axis(leaf_name) is not None
                leaf = ".".join(leaf_name.split(".")[-3:])
                whole = arrays[0][f"{name}/params{k}/{leaf_name}"]
                idx = shard_index(leaf, split, cfg.get("transformer_dim_head", 64))
                want = whole[idx.numpy()] if isinstance(idx, torch.Tensor) else whole[idx]
                assert np.array_equal(local, want), key
                checked += 1
    assert checked == len(ranks) * STEPS * 8
