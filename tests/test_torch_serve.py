"""The serving slice end to end on the CPU: the port's EnMAP-DFC classifier
(configs/finetune_config_enmap.yaml + configs/config.yaml) against the JAX
fused model (interpret mode) on the same converted weights, and the port's
Predictor against JAX ``model.apply``.

Tolerance: logits within 2e-5, the figure the JAX suite holds against the
upstream torch model (docs/DESIGN.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_finetune_config as jax_config
from maskedsst_tpu.train.factory import build_finetune_model as jax_build
from maskedsst_tpu_torch.config import get_finetune_config
from maskedsst_tpu_torch.io.flax_params import flax_from_params, params_from_flax
from maskedsst_tpu_torch.serve import Predictor
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.utils import profiling

CONFIGS = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")
ATOL = 2e-5


@pytest.fixture(scope="module")
def slice_models():
    """(JAX fused model, its params as numpy, the port's model on those params)."""
    jcfg = jax_config(*CONFIGS)
    jcfg.fused = True
    jmodel, _ = jax_build(jcfg)
    x0 = jnp.zeros((1, jcfg.n_bands, jcfg.image_size, jcfg.image_size), jnp.float32)
    variables = jax.jit(lambda k, v: jmodel.init(k, v, deterministic=True))(
        jax.random.PRNGKey(0), x0)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model, kwargs = build_finetune_model(get_finetune_config(*CONFIGS), device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    model.eval()
    assert kwargs == {"center_pixel": False}
    return jmodel, params, model


def _cubes(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 200, 8, 8)).astype(np.float32)


def test_slice_logits_match_jax_fused(slice_models):
    jmodel, params, model = slice_models
    x = _cubes(2, 0)
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a, deterministic=True))(
        params, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_flax_round_trip_is_exact(slice_models):
    _, params, model = slice_models
    back = flax_from_params(model.state_dict())
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_predictor_ragged_matches_jax_apply(slice_models):
    """N = 5 with batch 4: one full batch and a zero-padded tail of 1. The
    JAX side runs its XLA path (fused=False, the same param tree)."""
    jmodel, params, model = slice_models
    x = _cubes(5, 1)
    xla = jmodel.clone(fused=False)
    want = np.asarray(jax.jit(lambda p, a: xla.apply({"params": p}, a, deterministic=True))(
        params, jnp.asarray(x)))
    got = Predictor(model, batch_size=4, device="cpu")(x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_predictor_empty_keeps_shape_and_dtype(slice_models):
    _, _, model = slice_models
    out = Predictor(model, batch_size=4, device="cpu")(np.zeros((0, 200, 8, 8), np.float32))
    assert out.shape == (0, 8, 8, 8) and out.dtype == np.float32
    post = Predictor(model, batch_size=4, device="cpu", postprocess=lambda t: t.argmax(1))
    out = post(np.zeros((0, 200, 8, 8), np.float32))
    assert out.shape == (0, 8, 8) and out.dtype == np.int64


def test_predictor_postprocess_runs_per_batch(slice_models):
    _, _, model = slice_models
    x = _cubes(3, 2)
    logits = Predictor(model, batch_size=2, device="cpu")(x)
    labels = Predictor(model, batch_size=2, device="cpu", postprocess=lambda t: t.argmax(1))(x)
    np.testing.assert_array_equal(labels, logits.argmax(1))


def test_bf16_model_serves_finite_float32_logits():
    model, _ = build_finetune_model(get_finetune_config(*CONFIGS), dtype=torch.bfloat16,
                                    device="cpu")
    out = Predictor(model, batch_size=2, device="cpu")(_cubes(3, 3))
    assert out.shape == (3, 8, 8, 8) and out.dtype == np.float32 and np.isfinite(out).all()


@pytest.mark.parametrize("n", [0, 1, 3, 10])
def test_predictor_over_two_devices_equals_one(slice_models, n):
    """Each padded batch of 6 split over two devices (``"cpu:0"`` is a
    device of its own, so the second gets a copy of the model) gives the
    bits of one device at batch 3, on ragged N (0, 1, k, 3k + 1), the
    argmax postprocess too."""
    _, _, model = slice_models
    x = _cubes(n, 4)
    two = Predictor(model, batch_size=6, devices=["cpu", "cpu:0"])
    assert two.replicas[1] is not two.replicas[0] and two.per_device == 3
    one = Predictor(model, batch_size=3, device="cpu")
    got, want = two(x), one(x)
    assert got.shape == want.shape == (n, 8, 8, 8) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    post = dict(postprocess=lambda t: t.argmax(1))
    np.testing.assert_array_equal(Predictor(model, 6, devices=["cpu", "cpu"], **post)(x),
                                  Predictor(model, 3, device="cpu", **post)(x))


def test_predictor_batch_must_split_evenly_over_devices(slice_models):
    _, _, model = slice_models
    with pytest.raises(ValueError, match="not divisible by the 2 devices"):
        Predictor(model, batch_size=5, devices=["cpu", "cpu"])
    assert Predictor(model, batch_size=5, device="cpu").devices == [torch.device("cpu")]


@pytest.mark.parametrize("method", ["li", "ViTRGB"])
def test_unported_methods_raise(method):
    """Both methods the factory once refused now build and serve: li, the
    DeepHyperX 3-D CNN (ported with the zoo), and the factory's full-width
    EnMAP-DFC ViTRGB (S = 65 with its cls token), each through Predictor
    (a ragged tail) with the JAX model's logits on the same weights."""
    cfg = get_finetune_config(*CONFIGS)
    cfg.method_name = method
    if method == "li":
        from maskedsst_tpu.models.zoo import LiEtAl as JaxLiEtAl
        from maskedsst_tpu_torch.io.flax_params import zoo_flax_from_state

        cfg.pixelwise, cfg.patch_sub = True, 1
        model, kwargs = build_finetune_model(cfg, dtype=torch.bfloat16, device="cpu")
        assert kwargs["add_channel_dim"] and kwargs["center_pixel"]
        jmodel = JaxLiEtAl(input_channels=200, n_classes=8, n_planes=16, patch_size=7)
        x = _cubes(3, 4)[:, None, :, :7, :7]
        like = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a))(
            zoo_flax_from_state(model.state_dict(), like), jnp.asarray(x)))
        got = Predictor(model, batch_size=2, device="cpu")(x)
        assert got.shape == want.shape == (3, 8) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-5)
        return
    jcfg = jax_config(*CONFIGS)
    jcfg.method_name = method
    jmodel, jkwargs = jax_build(jcfg)
    x0 = jnp.zeros((1, jcfg.n_bands, jcfg.image_size, jcfg.image_size), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, v: jmodel.init(k, v, deterministic=True))(jax.random.PRNGKey(3), x0)["params"])
    model, kwargs = build_finetune_model(cfg, device="cpu")
    assert kwargs == jkwargs == {}
    model.load_state_dict(params_from_flax(params), strict=True)
    x = _cubes(3, 4)
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a, deterministic=True))(
        params, jnp.asarray(x)))
    got = Predictor(model, batch_size=2, device="cpu")(x)
    assert got.shape == want.shape == (3, 8, 8, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# --- host spans ---------------------------------------------------------------

class _FirstColumns(torch.nn.Module):
    """A stand-in served model: each row's first three values as its logits."""

    logits_shape = (3,)
    compute_dtype = torch.float32

    def forward(self, x):
        return x.reshape(x.shape[0], -1)[:, :3]


def _traced_call(predictor, x):
    from torch.profiler import ProfilerActivity, profile

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = predictor(x)
    return out, profiling.recorded_spans()


def test_predictor_spans_count_rows_batches_and_nest_per_batch():
    """A ragged call (300 rows at batch 256) under a profiler: one
    ``serve.call`` counting 300 rows asked, 512 run, 2 batches; each batch
    one ``copy_in``, ``forward`` and ``copy_out`` in that order, children of
    the call by ``parent_id``, each inside its parent's interval."""
    x = np.arange(300 * 8, dtype=np.float32).reshape(300, 2, 2, 2)
    out, spans = _traced_call(Predictor(_FirstColumns(), batch_size=256, device="cpu"), x)
    np.testing.assert_array_equal(out, x.reshape(300, -1)[:, :3])
    calls = [s for s in spans if s[0] == "serve.call"]
    assert len(calls) == 1 and len(spans) == 7
    name, call_id, parent, start, end, counts = calls[0]
    assert parent is None and counts == {"rows": 300, "rows_run": 512, "batches": 2}
    children = sorted((s for s in spans if s[0] != "serve.call"), key=lambda s: s[3])
    assert [s[0] for s in children] == ["serve.copy_in", "serve.forward", "serve.copy_out"] * 2
    for s in children:
        assert s[2] == call_id and start <= s[3] <= s[4] <= end and s[5] == {}
    assert all(a[4] <= b[3] for a, b in zip(children, children[1:]))


def test_predictor_records_nothing_without_a_profiler():
    profiling.clear_spans()
    Predictor(_FirstColumns(), batch_size=4, device="cpu")(np.zeros((5, 2, 2, 2), np.float32))
    assert profiling.recorded_spans() == [] and profiling.dropped_spans() == 0


@pytest.mark.parametrize("n,batch", [(300, 256), (0, 4), (8, 4), (9, 4)])
def test_predictor_rows_run_equals_what_a_forward_pre_hook_counts(n, batch):
    """The padded rows counted on ``serve.call`` are the rows the model is
    called on, as the benchmark's forward pre-hook counts them."""
    model, hooked = _FirstColumns(), []
    model.register_forward_pre_hook(lambda module, args: hooked.append(args[0].shape[0]))
    _, spans = _traced_call(Predictor(model, batch_size=batch, device="cpu"),
                            np.zeros((n, 2, 2, 2), np.float32))
    (call,) = [s for s in spans if s[0] == "serve.call"]
    assert call[5]["rows_run"] == sum(hooked) and call[5]["batches"] == len(hooked)
    assert call[5]["rows"] == n
